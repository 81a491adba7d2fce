"""Serving parallelism of the port: the process-group mesh (mesh.py), its
collectives (comm.py), tensor parallelism of the DiT (tp.py) and the
multi-host frame fan-out (multihost.py)."""
