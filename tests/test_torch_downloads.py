"""seedvr2_tpu_torch.utils.downloads against the JAX package's
utils/downloads.py, scenario by scenario of tests/test_downloads.py, each
run through both packages against a Range-honouring HTTP server on
127.0.0.1 (that file's _RangeHandler): a fresh download, a resume after
truncation, a server that ignores Range, a failure mid-transfer, a
checksum mismatch, a corrupt local file, the validation cache skipping a
rehash, no checksum accepting an existing file and no checksum never
resuming a stale partial. The files left in the model directory, the
validation cache, the requests served and the return value (or the raised
type and message) are equal in both packages, and each scenario's own
expectation holds in both.

No test reaches past 127.0.0.1: the registry's download URL points at a
closed local port in both packages, so a stray request fails at once."""

import hashlib
import http.server
import os
import threading

import pytest

from seedvr2_tpu.utils import downloads as jdl
from seedvr2_tpu.utils import model_registry as jreg
from seedvr2_tpu_torch.utils import downloads as tdl
from seedvr2_tpu_torch.utils import model_registry as treg

from .test_downloads import PAYLOAD, SHA, _RangeHandler

PACKAGES = {"port": (tdl, treg), "jax": (jdl, jreg)}
# a local port nothing listens on: a request the test did not point at its
# server is refused at once instead of leaving the machine
CLOSED_URL = "http://127.0.0.1:9/{repo}/{filename}"


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    for dl, _ in PACKAGES.values():
        monkeypatch.setattr(dl, "HUGGINGFACE_BASE_URL", CLOSED_URL)


@pytest.fixture
def server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _reset_server():
    _RangeHandler.ignore_range = False
    _RangeHandler.truncate_at = None
    _RangeHandler.served_ranges = []


def _registry(monkeypatch, dl, reg, sha=None):
    """The JAX test's fake registry: no checksum for names with "nosha",
    else the payload's (or `sha`)."""
    monkeypatch.setattr(dl, "get_model_info", lambda name: reg.ModelInfo(
        sha256=None if "nosha" in name else (sha or SHA)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _fresh(dl, d, url, monkeypatch):
    path = dl.download_weight("w.safetensors", d, url=f"{url}/w.safetensors")
    assert _read(path) == PAYLOAD
    assert dl._load_cache(d)["w.safetensors"]["sha256"] == SHA
    return path


def _resume(dl, d, url, monkeypatch):
    cut = 100 * 1024
    temp = os.path.join(d, "w.safetensors.download")
    with open(temp, "wb") as f:
        f.write(PAYLOAD[:cut])
    path = dl.download_weight("w.safetensors", d, url=f"{url}/w.safetensors")
    assert _read(path) == PAYLOAD
    assert (f"bytes={cut}-", cut) in _RangeHandler.served_ranges
    assert not os.path.exists(temp)
    return path


def _ignores_range(dl, d, url, monkeypatch):
    _RangeHandler.ignore_range = True
    with open(os.path.join(d, "w.safetensors.download"), "wb") as f:
        f.write(b"\xff" * 4096)
    path = dl.download_weight("w.safetensors", d, url=f"{url}/w.safetensors")
    assert _read(path) == PAYLOAD
    return path


def _mid_transfer(dl, d, url, monkeypatch):
    _RangeHandler.truncate_at = 64 * 1024
    real, calls = dl.download_with_resume, []

    def flaky(src, filepath, debug=None, **kw):
        calls.append(1)
        if len(calls) == 2:
            _RangeHandler.truncate_at = None  # the server recovers
        return real(src, filepath, debug, **kw)

    monkeypatch.setattr(dl, "download_with_resume", flaky)
    path = dl.download_weight("w.safetensors", d, url=f"{url}/w.safetensors")
    assert _read(path) == PAYLOAD
    assert any(r and r.startswith("bytes=") and s > 0
               for r, s in _RangeHandler.served_ranges)
    return path


def _sha_mismatch(dl, d, url, monkeypatch):
    with pytest.raises(IOError, match="cannot obtain") as err:
        dl.download_weight("w.safetensors", d, url=f"{url}/w.safetensors")
    assert not os.path.exists(os.path.join(d, "w.safetensors"))
    assert "w.safetensors" not in dl._load_cache(d)
    return f"{type(err.value).__name__}: {err.value}"


def _corrupt_local(dl, d, url, monkeypatch):
    with open(os.path.join(d, "w.safetensors"), "wb") as f:
        f.write(b"corrupt")
    path = dl.download_weight("w.safetensors", d, url=f"{url}/w.safetensors")
    assert _read(path) == PAYLOAD
    return path


def _cache_skips_rehash(dl, d, url, monkeypatch):
    target = os.path.join(d, "w.safetensors")
    with open(target, "wb") as f:
        f.write(PAYLOAD)
    assert dl.validate_file(target, SHA, d)
    hashes, real = [], dl.sha256_file
    monkeypatch.setattr(dl, "sha256_file",
                        lambda p, **kw: (hashes.append(p), real(p))[1])
    assert dl.validate_file(target, SHA, d)
    assert hashes == []
    st = os.stat(target)
    os.utime(target, (st.st_atime, st.st_mtime + 10))
    assert dl.validate_file(target, SHA, d)
    assert hashes == [target]
    return len(hashes)


def _nosha_existing(dl, d, url, monkeypatch):
    target = os.path.join(d, "custom_nosha.safetensors")
    with open(target, "wb") as f:
        f.write(b"whatever")
    path = dl.download_weight("custom_nosha.safetensors", d)
    assert path == target
    return path


def _nosha_stale_partial(dl, d, url, monkeypatch):
    with open(os.path.join(d, "w_nosha.safetensors.download"), "wb") as f:
        f.write(b"stale bytes from an older upstream version")
    path = dl.download_weight("w_nosha.safetensors", d,
                              url=f"{url}/w_nosha.safetensors")
    assert _read(path) == PAYLOAD
    assert all(rng is None for rng, _ in _RangeHandler.served_ranges)
    return path


SCENARIOS = {"fresh": _fresh, "resume_after_truncation": _resume,
             "server_ignores_range": _ignores_range,
             "mid_transfer_failure": _mid_transfer,
             "sha_mismatch": _sha_mismatch, "corrupt_local": _corrupt_local,
             "cache_skips_rehash": _cache_skips_rehash,
             "nosha_existing": _nosha_existing,
             "nosha_stale_partial": _nosha_stale_partial}


def _run(pkg, scenario, d, url, monkeypatch):
    """One scenario through one package in directory d: what it returned
    (a path relative to d), the files left (name -> sha256), the cache
    (each entry's mtime replaced by whether it is its file's) and the
    requests served."""
    dl, reg = PACKAGES[pkg]
    _reset_server()
    _registry(monkeypatch, dl, reg,
              "0" * 64 if scenario == "sha_mismatch" else None)
    with monkeypatch.context() as m:
        result = SCENARIOS[scenario](dl, str(d), url, m)
    if isinstance(result, str) and result.startswith(str(d)):
        result = os.path.relpath(result, d)
    files = {n: hashlib.sha256(_read(d / n)).hexdigest()
             for n in sorted(os.listdir(d))
             if n != ".sha256_validation_cache.json"}
    cache = {n: {**e, "mtime": e["mtime"] == os.stat(d / n).st_mtime}
             for n, e in dl._load_cache(str(d)).items()}
    return dict(result=result, files=files, cache=cache,
                served=list(_RangeHandler.served_ranges))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_download_scenario_matches_jax(scenario, server, tmp_path,
                                       monkeypatch):
    runs = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        runs[pkg] = _run(pkg, scenario, d, server, monkeypatch)
    assert runs["port"] == runs["jax"]


def test_constants_and_cache_name_match_jax():
    for name in ("MAX_RETRIES", "DOWNLOAD_CHUNK_SIZE",
                 "HUGGINGFACE_BASE_URL", "_CACHE_NAME"):
        assert getattr(tdl, name) == getattr(jdl, name), name


def test_download_error_paths_match_jax(server, tmp_path):
    """download_with_resume's failure returns: a 404 (False, nothing
    written), a 416 on a partial that covers the file (finalised, True)
    and allow_resume=False discarding a partial, in both packages."""

    class Missing(_RangeHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            self.send_error(404)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Missing)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        for pkg, (dl, _) in PACKAGES.items():
            d = tmp_path / pkg
            d.mkdir()
            _reset_server()
            gone = f"http://127.0.0.1:{srv.server_address[1]}/x"
            assert dl.download_with_resume(gone, str(d / "x")) is False
            assert os.listdir(d) == []
            (d / "w.download").write_bytes(PAYLOAD)
            assert dl.download_with_resume(f"{server}/w", str(d / "w"))
            assert _read(d / "w") == PAYLOAD
            assert _RangeHandler.served_ranges == []  # 416: nothing served
            (d / "v.download").write_bytes(b"old")
            assert dl.download_with_resume(f"{server}/v", str(d / "v"),
                                           allow_resume=False)
            assert _read(d / "v") == PAYLOAD
            assert sorted(os.listdir(d)) == ["v", "w"]
    finally:
        srv.shutdown()
        srv.server_close()
