"""Workflow-file execution over the port's node API (counterpart of
seedvr2_tpu.interfaces.workflow).

A workflow file is a JSON object {"nodes": [{"id", "type", "params",
"inputs"}]} whose "inputs" map a parameter name to another node's id (its
execute() result). Node types resolve to the classes in
interfaces/nodes.py, so a workflow runs the same code as the nodes; the
shipped examples/workflows/*.json (mirrors of the reference's ComfyUI
example workflows) run unchanged:

    {"nodes": [
      {"id": "dit", "type": "SeedVR2LoadDiTModel",
       "params": {"model": "seedvr2_ema_3b_fp16.safetensors"}},
      {"id": "vae", "type": "SeedVR2LoadVAEModel", "params": {}},
      {"id": "up", "type": "SeedVR2VideoUpscaler",
       "params": {"resolution": 1080, "seed": 42},
       "inputs": {"dit": "dit", "vae": "vae", "image": "__input__.image"}}
    ]}

`__input__` binds to the `inputs` dict given to run_workflow: `__input__`
alone to the entry named like the parameter, `__input__.key` to `key`.
"""

import json
from typing import Any, Dict

from . import nodes as node_mod


def _node_class(type_name: str):
    cls = getattr(node_mod, type_name, None)
    if cls is None:
        raise ValueError(f"unknown node type: {type_name}")
    return cls


def run_workflow(workflow: Dict[str, Any],
                 inputs: Dict[str, Any] = None) -> Dict[str, Any]:
    """Execute a workflow graph in node order; returns {node_id: result}."""
    inputs = inputs or {}
    results: Dict[str, Any] = {}
    for node in workflow["nodes"]:
        kwargs = dict(node.get("params", {}))
        for name, src in node.get("inputs", {}).items():
            if isinstance(src, str) and src.startswith("__input__"):
                key = src[len("__input__"):].lstrip(".") or name
                kwargs[name] = inputs[key]
            else:
                kwargs[name] = results[src]
        results[node["id"]] = _node_class(node["type"]).execute(**kwargs)
    return results


def run_workflow_file(path: str, inputs: Dict[str, Any] = None):
    with open(path) as f:
        return run_workflow(json.load(f), inputs)
