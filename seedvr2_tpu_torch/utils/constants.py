"""Model-path resolution (reference: src/utils/constants.py).

A copy of seedvr2_tpu.utils.constants, pinned equal to it by
tests/test_torch_model_manager.py. Search order for a checkpoint filename:
 1. absolute / existing relative path (used as-is),
 2. $SEEDVR2_MODEL_PATHS (os.pathsep-separated directories),
 3. the provided base dir (CLI --model_dir, default ./models),
 4. ComfyUI installs: <comfyui>/models/SEEDVR2 plus every path listed under
    a `SEEDVR2`/`seedvr2` key in extra_model_paths.yaml (case-insensitive
    key match, mirroring constants.py:63-118; `yaml` is optional).

Returns None when not found; core/model_manager.configure_runner then
downloads the file into the base dir (utils/downloads.py), as in JAX.
"""

import os
from typing import List, Optional

# GGUF block sizes (constants.py GGUF section) — re-exported for tooling
GGUF_BLOCK_SIZE = 32
GGUF_K_BLOCK_SIZE = 256


def _comfyui_roots() -> List[str]:
    roots = []
    env = os.environ.get("COMFYUI_PATH")
    if env:
        roots.append(env)
    here = os.path.abspath(os.path.dirname(__file__))
    # installed as <comfyui>/custom_nodes/<pkg>/... -> walk up looking for
    # the ComfyUI root (has models/ + extra_model_paths.yaml or main.py)
    cur = here
    for _ in range(6):
        cur = os.path.dirname(cur)
        if os.path.isdir(os.path.join(cur, "models")) and (
                os.path.isfile(os.path.join(cur, "main.py"))
                or os.path.isfile(os.path.join(cur, "extra_model_paths.yaml"))):
            roots.append(cur)
            break
    return roots


def _extra_model_path_dirs(root: str) -> List[str]:
    """Parse extra_model_paths.yaml for SEEDVR2 dirs (case-insensitive)."""
    yaml_path = os.path.join(root, "extra_model_paths.yaml")
    if not os.path.isfile(yaml_path):
        return []
    try:
        import yaml  # type: ignore

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
    except Exception:
        return []
    dirs: List[str] = []
    for _group, section in (data.items() if isinstance(data, dict) else []):
        if not isinstance(section, dict):
            continue
        base = section.get("base_path", "")
        for key, val in section.items():
            if key.lower() == "seedvr2" and isinstance(val, str):
                for line in val.splitlines():
                    line = line.strip()
                    if line:
                        dirs.append(os.path.join(base, line)
                                    if base and not os.path.isabs(line)
                                    else line)
    return dirs


def candidate_model_dirs(base_dir: Optional[str] = None) -> List[str]:
    dirs: List[str] = []
    env = os.environ.get("SEEDVR2_MODEL_PATHS")
    if env:
        dirs.extend(p for p in env.split(os.pathsep) if p)
    if base_dir:
        dirs.append(base_dir)
    for root in _comfyui_roots():
        dirs.append(os.path.join(root, "models", "SEEDVR2"))
        dirs.extend(_extra_model_path_dirs(root))
    seen, out = set(), []
    for d in dirs:
        d = os.path.abspath(os.path.expanduser(d))
        if d not in seen:
            seen.add(d)
            out.append(d)
    return out


def find_model_path(name: str, base_dir: Optional[str] = None) -> Optional[str]:
    """Resolve a checkpoint filename to an existing path (or None)."""
    if os.path.isfile(name):
        return name
    for d in candidate_model_dirs(base_dir):
        p = os.path.join(d, name)
        if os.path.isfile(p):
            return p
        # case-insensitive filename match (constants.py matches loosely)
        if os.path.isdir(d):
            low = name.lower()
            for f in os.listdir(d):
                if f.lower() == low:
                    return os.path.join(d, f)
    return None
