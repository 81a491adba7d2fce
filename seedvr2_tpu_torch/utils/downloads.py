"""Weight downloads with resume, SHA256 validation and a validation cache.

Port of seedvr2_tpu.utils.downloads (the reference's
src/utils/downloads.py:26-240), with the same functions, constants and
behaviour, held equal to it by tests/test_torch_downloads.py:

 - `download_with_resume`: HTTP transfer into a `.download` temp file,
   resuming a partial with a Range request; a 200 answer to a Range request
   restarts from byte 0, a short read keeps the partial for the next
   attempt, 416 finalises the partial, allow_resume=False discards it;
 - `validate_file` / `is_file_validated_cached`: SHA256 checks with a
   size / mtime cache (`.sha256_validation_cache.json` in the model
   directory), so repeated runs skip rehashing multi-GB files;
 - `download_weight`: validate, delete a corrupt file and drop its cache
   entry, up to MAX_RETRIES resumable downloads, a `url` override (tests,
   mirrors), and an unvalidated local file as the last resort.

The transfer is plain urllib, so it needs no hub client; the checksums and
repositories come from the port's utils/model_registry.py.
"""

import hashlib
import json
import os
import urllib.error
import urllib.request
from typing import Optional

from .model_registry import get_model_info

MAX_RETRIES = 3
DOWNLOAD_CHUNK_SIZE = 1 << 20
HUGGINGFACE_BASE_URL = "https://huggingface.co/{repo}/resolve/main/{filename}"
_CACHE_NAME = ".sha256_validation_cache.json"


def _cache_path(model_dir: str) -> str:
    return os.path.join(model_dir, _CACHE_NAME)


def _load_cache(model_dir: str) -> dict:
    try:
        with open(_cache_path(model_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cache(model_dir: str, cache: dict):
    try:
        with open(_cache_path(model_dir), "w") as f:
            json.dump(cache, f)
    except OSError:
        pass


def _drop_cache_entry(model_dir: str, filename: str):
    cache = _load_cache(model_dir)
    if filename in cache:
        del cache[filename]
        _save_cache(model_dir, cache)


def _log(debug, message: str, level: str):
    if debug:
        debug.log(message, level=level, category="download", force=True)


def sha256_file(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def is_file_validated_cached(path: str, expected_sha: Optional[str],
                             model_dir: str) -> bool:
    """Fast path: trust an earlier hash while the file's size and mtime are
    unchanged (mtime within 2 s)."""
    if not os.path.isfile(path):
        return False
    st = os.stat(path)
    entry = _load_cache(model_dir).get(os.path.basename(path))
    return bool(entry
                and entry.get("size") == st.st_size
                and abs(entry.get("mtime", 0) - st.st_mtime) < 2
                and (expected_sha is None
                     or entry.get("sha256") == expected_sha))


def validate_file(path: str, expected_sha: Optional[str],
                  model_dir: str) -> bool:
    """Whether `path` exists and hashes to `expected_sha` (None: exists),
    through the validation cache; a full hash refreshes the file's entry."""
    if expected_sha is None:
        return os.path.isfile(path)
    if is_file_validated_cached(path, expected_sha, model_dir):
        return True
    if not os.path.isfile(path):
        return False
    # stat before hashing: a file modified while it is hashed then no longer
    # matches the cached size / mtime, so the entry is not trusted later
    st = os.stat(path)
    actual = sha256_file(path)
    cache = _load_cache(model_dir)
    cache[os.path.basename(path)] = {
        "size": st.st_size, "mtime": st.st_mtime, "sha256": actual}
    _save_cache(model_dir, cache)
    return actual == expected_sha


def download_with_resume(url: str, filepath: str, debug=None,
                         chunk: int = DOWNLOAD_CHUNK_SIZE,
                         timeout: float = 30.0,
                         allow_resume: bool = True) -> bool:
    """Stream `url` to `filepath` through `<filepath>.download`, resuming a
    partial transfer with a Range request. A server that ignores the Range
    header (200 instead of 206) restarts the transfer from byte 0, so a
    full body is never appended to a partial. A connection closed early
    keeps the partial for the next attempt and returns False; 416 (the
    partial already covers the file) finalises it for the caller's checksum
    to judge. allow_resume=False discards an existing partial first: with no
    checksum to verify the result, a stale partial spliced with a new tail
    would pass unnoticed. Returns whether `filepath` was written."""
    temp_file = f"{filepath}.download"
    if not allow_resume and os.path.exists(temp_file):
        os.remove(temp_file)
    existing = os.path.getsize(temp_file) if os.path.exists(temp_file) else 0
    headers = {"Range": f"bytes={existing}-"} if existing > 0 else {}
    try:
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as response:
            resumed = existing > 0 and response.status == 206
            expected = int(response.headers.get("Content-Length", 0) or 0)
            got = 0
            with open(temp_file, "ab" if resumed else "wb") as f:
                while True:
                    data = response.read(chunk)
                    if not data:
                        break
                    f.write(data)
                    got += len(data)
        if expected and got < expected:
            _log(debug, f"short read ({got}/{expected} bytes), will resume",
                 "WARNING")
            return False
        os.replace(temp_file, filepath)
        return True
    except urllib.error.HTTPError as e:
        if e.code == 416 and existing > 0:
            os.replace(temp_file, filepath)
            return True
        _log(debug, f"download error: {e}", "ERROR")
        return False
    except Exception as e:  # noqa: BLE001 - the partial stays for a resume
        _log(debug, f"download error: {e}", "ERROR")
        return False


def download_weight(model_name: str, model_dir: str, debug=None,
                    url: Optional[str] = None) -> str:
    """A validated local path for the named weight, downloaded when missing
    or corrupt: the validation cache, then a full hash of an existing file
    (a corrupt one is deleted and its cache entry dropped), then up to
    MAX_RETRIES resumable downloads from `url` (default: the registry's
    repository on the Hugging Face hub). A file without a registry checksum
    is accepted as it is; when every attempt fails, a local file that could
    not be validated is returned, else IOError("cannot obtain ...")."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, model_name)
    info = get_model_info(model_name)
    if validate_file(path, info.sha256, model_dir):
        return path
    if os.path.isfile(path):
        if info.sha256 is None:
            return path
        _log(debug, f"file corrupted: {model_name}, re-downloading",
             "WARNING")
        os.remove(path)
        _drop_cache_entry(model_dir, model_name)

    src = url or HUGGINGFACE_BASE_URL.format(repo=info.repo,
                                             filename=model_name)
    last_err = None
    for attempt in range(MAX_RETRIES):
        try:
            if not download_with_resume(src, path, debug,
                                        allow_resume=info.sha256 is not None):
                raise IOError(f"transfer failed for {model_name}")
            if validate_file(path, info.sha256, model_dir):
                return path
            os.remove(path)
            _drop_cache_entry(model_dir, model_name)
            raise IOError(f"checksum mismatch for {model_name}")
        except Exception as e:  # noqa: BLE001 - retried with a resume
            last_err = e
            _log(debug, f"download attempt {attempt + 1} failed: {e}",
                 "WARNING")
    if os.path.isfile(path):
        _log(debug, f"using unvalidated local file {path}", "WARNING")
        return path
    raise IOError(f"cannot obtain {model_name}: {last_err}")
