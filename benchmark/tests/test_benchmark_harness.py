"""A whole run of the harness on the CPU at a tiny size, past its look for
a chip: a sound run reads `correct`, and each fault a cell can have,
planted underneath the timed path, reads not correct."""

import dataclasses
import json

import pytest
import torch

from benchmark import harness, program
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core.configs import VAEConfig, small_test_config

TINY_VAE = VAEConfig(block_out_channels=(8, 16, 32, 32), norm_num_groups=4)


def _tiny_cell(family="dit_3b", quant="none"):
    dit = {f.name: getattr(small_test_config(family, num_layers=2), f.name)
           for f in dataclasses.fields(small_test_config(family))}
    dit = {k: list(v) if isinstance(v, tuple) else v for k, v in dit.items()}
    vae = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(TINY_VAE).items()}
    vae.pop("conv_quant")
    with open(harness.HERE / "configs" / "seedvr2-3b.json") as f:
        lane = json.load(f)["lane"]
    cfg = {"name": "tiny", "dit": dit, "vae": vae,
           "lane": {**lane, "quant": quant}}
    mix = {"frames": 5, "height": 24, "width": 40, "resolution": 48,
           "batch_size": 5, "pool": 2, "loop": "closed", "clients": 1,
           "check_requests": 2,
           "txt_len": 5, "neg_len": 6}
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    return harness.Cell(name="tiny", cfg=cfg, mix=mix,
                        limits={"rms": {"limit": 0.05}},
                        end_to_end=bench["end_to_end"],
                        per_layer=bench["per_layer"])


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(cli, "VAE_V3", TINY_VAE)
    return _tiny_cell()


def _run(cell, traced=False):
    return harness.run_cell(cell, 7, 0.5, traced, torch.device("cpu"), 0.0)


def test_sound_run_is_correct(tiny):
    result = _run(tiny)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1
    assert list(result)[-1] == "check"
    # every end-to-end metric but the device memory, which the CPU lacks
    assert set(result["metrics"]) == {"frames_per_s", "request_p95_s",
                                      "setup_s"}


def test_traced_run_reads_the_program_spans(tiny):
    result = _run(tiny, traced=True)
    assert result["correct"]
    m = result["metrics"]
    for name in ("vae.encode_s", "vae.decode_s", "dit.step_s",
                 "post.postprocess_s", "device.mfu"):
        assert m[name]["value"] > 0
    # no device, no device trace: the kernels' shares are left out
    assert "kernels.k1_roofline" not in m


def _altered_frame(serve):
    def broken(*a, **k):
        out, t = serve(*a, **k)
        out = out.copy()
        out[-1] = out[-1, :, ::-1]
        return out, t
    return broken


def _half_batch(serve):
    def broken(runner, pool, i, cfg, seed):
        out, t = serve(runner, pool, i, cfg, seed)
        return out[: out.shape[0] // 2], t
    return broken


def _unchanged_step(serve):
    def broken(runner, *a, **k):
        runner.inference = lambda noises, conditions, **kw: list(noises)
        return serve(runner, *a, **k)
    return broken


@pytest.mark.parametrize("fault", [_altered_frame, _half_batch,
                                   _unchanged_step])
def test_fault_reads_not_correct(tiny, monkeypatch, fault):
    monkeypatch.setattr(program, "serve", fault(program.serve))
    result = _run(tiny)
    assert not result["correct"], result["check"]


def test_run_needs_a_card(monkeypatch, capsys):
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "3b-clip1080", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""

