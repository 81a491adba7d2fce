"""Process-wide model cache.

A copy of seedvr2_tpu.core.model_cache (the reference's GlobalModelCache,
src/core/model_cache.py:10-238): keeps loaded DiTs and VAEs (modules placed
as their runner serves them) and configured runners across jobs, keyed by
checkpoint path + the options that invalidate them
(core/model_manager.configure_runner builds the keys). A runner cache hit
skips the weight load, the conversion and the upload."""

import threading
from typing import Any, Dict, Optional


class GlobalModelCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._dit: Dict[str, Any] = {}
        self._vae: Dict[str, Any] = {}
        self._runners: Dict[str, Any] = {}

    def get_dit(self, key: str):
        with self._lock:
            return self._dit.get(key)

    def set_dit(self, key: str, params):
        with self._lock:
            self._dit[key] = params

    def get_vae(self, key: str):
        with self._lock:
            return self._vae.get(key)

    def set_vae(self, key: str, vae):
        with self._lock:
            self._vae[key] = vae

    def get_runner(self, key: str):
        with self._lock:
            return self._runners.get(key)

    def set_runner(self, key: str, runner):
        with self._lock:
            self._runners[key] = runner

    def clear(self, kind: Optional[str] = None):
        with self._lock:
            if kind in (None, "dit"):
                self._dit.clear()
            if kind in (None, "vae"):
                self._vae.clear()
            if kind in (None, "runner"):
                self._runners.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"dit": len(self._dit), "vae": len(self._vae),
                    "runners": len(self._runners)}


_GLOBAL_CACHE = GlobalModelCache()


def get_global_cache() -> GlobalModelCache:
    return _GLOBAL_CACHE
