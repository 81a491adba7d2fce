"""The plain reference of a SeedVR2 request (float32, plain torch and
numpy), against which every benchmark run judges the program's output. It
imports nothing of the program and nothing of JAX."""
