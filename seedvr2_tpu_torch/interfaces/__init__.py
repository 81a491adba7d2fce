"""The ComfyUI node API on the port: SeedVR2LoadDiTModel,
SeedVR2LoadVAEModel, SeedVR2TorchCompileSettings and SeedVR2VideoUpscaler
(the reference's src/interfaces/ config-dict contract; counterpart of
seedvr2_tpu.interfaces).

The nodes are plain Python (dict in / dict out, numpy frames), so any host
application can call them, and interfaces/workflow.py runs their JSON
graphs; under ComfyUI, `comfy_entrypoint` registers them."""

from .nodes import (SeedVR2LoadDiTModel, SeedVR2LoadVAEModel,
                    SeedVR2TorchCompileSettings, SeedVR2VideoUpscaler)

NODE_CLASS_MAPPINGS = {
    "SeedVR2LoadDiTModel": SeedVR2LoadDiTModel,
    "SeedVR2LoadVAEModel": SeedVR2LoadVAEModel,
    "SeedVR2TorchCompileSettings": SeedVR2TorchCompileSettings,
    "SeedVR2VideoUpscaler": SeedVR2VideoUpscaler,
}


def comfy_entrypoint():  # pragma: no cover - needs the ComfyUI runtime
    return NODE_CLASS_MAPPINGS
