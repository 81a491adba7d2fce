"""`python -m seedvr2_tpu_torch.cli --doctor`: an environment health report.

Port of seedvr2_tpu.utils.doctor. The report covers what goes wrong in
deployment: the versions, OpenCV (video and image IO), the two native
libraries (the g++ host library, built and loaded here; the CUDA kernel
library, whose build for the current sources is looked for and not made),
the memory-probe cache (a cold cache explains a slow first `auto`-tiled
request), and model / asset resolution (search dirs, default checkpoints,
text embeddings; a missing file reads NOT FOUND, as the port downloads
nothing). Then it probes the CUDA device under a watchdog thread, so the
doctor never hangs on a wedged CUDA runtime.

Exit code: 0 iff the card computed; 3 if no CUDA device is visible or the
probe failed or timed out. So on a host without a GPU the port's doctor
returns 3, where JAX's returns 0 on its CPU backend: the port's backend is
the card.
"""

import os
import threading
import time
from typing import Optional

# how long a device probe may block before the doctor calls it wedged
BACKEND_PROBE_S = 60.0


def _probe_backend(timeout_s: float):
    """(status dict) without ever hanging: the first CUDA work runs in a
    daemon thread; a wedged runtime call just strands that thread."""
    result = {}
    done = threading.Event()

    def run():
        try:
            import torch

            if not torch.cuda.is_available():
                result.update(ok=False, error="no CUDA device is visible "
                                              "(torch.cuda.is_available() is "
                                              "false)")
                return
            t0 = time.perf_counter()
            x = torch.ones((256, 256), dtype=torch.bfloat16, device="cuda")
            float((x @ x).float().mean())
            free, total = torch.cuda.mem_get_info()
            result.update(
                ok=True, backend="cuda", n_devices=torch.cuda.device_count(),
                device_kind=torch.cuda.get_device_name(0),
                first_compute_s=round(time.perf_counter() - t0, 2),
                hbm_limit_gb=round(total / 1e9, 1),
                hbm_in_use_gb=round((total - free) / 1e9, 2))
        except Exception as exc:  # noqa: BLE001 — reported, exit code 3
            result.update(ok=False, error=repr(exc)[:300])
        finally:
            done.set()

    threading.Thread(target=run, daemon=True, name="doctor-probe").start()
    if not done.wait(timeout_s):
        return {"ok": False,
                "error": f"CUDA init still blocked after {timeout_s:.0f}s"}
    return result


def run_doctor(model_dir: Optional[str] = None, echo=print) -> int:
    import platform
    import sys

    import numpy as np
    import torch

    echo("== seedvr2 doctor ==")
    echo(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
         f"cuda {torch.version.cuda} | numpy {np.__version__} | "
         f"{platform.platform()}")
    try:
        import cv2

        echo(f"opencv {cv2.__version__}")
    except ImportError:
        echo("opencv MISSING (video/image IO unavailable; .npy frames "
             "still work)")

    # native libraries ----------------------------------------------------
    try:
        from ..ops import native

        native.library()
        echo(f"host library (g++): loaded from {native.BUILD_DIR}")
    except Exception as exc:  # noqa: BLE001 — reported, not fatal
        echo(f"host library (g++): error ({exc!r})"[:400])
    from ..ops import _build

    lib = _build.library_path()
    state = ("built" if lib.exists()
             else "NOT built (nvcc builds it at the first kernel launch)")
    echo(f"CUDA kernel library: {lib} ({state})")

    # caches ------------------------------------------------------------
    from . import memplan

    mp = memplan._cache_path()
    n_probes = len(memplan._load_cache()) if os.path.isfile(mp) else 0
    echo(f"memory-probe cache: {mp} ({n_probes} probed tile shapes)")

    # model/asset resolution ----------------------------------------------
    from .constants import candidate_model_dirs, find_model_path
    from .model_registry import DEFAULT_DIT, DEFAULT_VAE
    from .text_embeds import ASSET_DIRS, find_embedding_path

    dirs = candidate_model_dirs(model_dir)
    echo(f"model search dirs: {dirs}")
    for name in (DEFAULT_DIT, DEFAULT_VAE):
        p = find_model_path(name, model_dir)
        echo(f"  {name}: {p or 'NOT FOUND (downloads are not ported)'}")
    for emb in ("pos", "neg"):
        found = find_embedding_path(emb, dirs)
        if found and os.path.dirname(found) in ASSET_DIRS:
            found = f"{found} (packaged published embeddings)"
        missing = ("NOT FOUND — published models will refuse to run "
                   "unconditioned (pass --allow_zero_embeddings to bench)")
        echo(f"  {emb}_emb: {found or missing}")

    # backend ------------------------------------------------------------
    echo(f"probing backend (<= {BACKEND_PROBE_S:.0f}s) ...")
    r = _probe_backend(BACKEND_PROBE_S)
    if r.get("ok"):
        echo(f"backend OK: {r['backend']} x{r['n_devices']} "
             f"({r['device_kind']}), first compute "
             f"{r['first_compute_s']}s, HBM {r['hbm_in_use_gb']}/"
             f"{r['hbm_limit_gb']} GB")
        return 0
    echo(f"backend UNAVAILABLE: {r.get('error')}")
    if "still blocked" in str(r.get("error", "")):
        # the probe thread is stranded inside a runtime call; skip the
        # interpreter's teardown, which would wait on it
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(3)
    return 3
