"""chip_smoke.py's phases at 64x64 on the CPU backend (the card runs them at
full size), and its refusal to do any work without a GPU."""
import json

import jax
import numpy as np
import pytest

import chip_smoke as CS
from benchmarks import trace_stages as TS
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu.utils import synthetic_clip


def test_device_check_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        CS.device_check()


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_stops_at_phase_0_without_a_gpu(argv, capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        CS.main(argv)
    out = capsys.readouterr().out
    assert '"ok"' not in out and "[phase 1" not in out


@pytest.mark.parametrize("make_cfg", [CS.library_cfg, CS.fast_me_cfg], ids=["full", "fast_me"])
def test_closed_loop_phase(make_cfg, tmp_path):
    cfg = make_cfg(64, 64, 4)
    res = CS.closed_loop(cfg, synthetic_clip(64, 64, 4, seed=0), "t", out_dir=tmp_path)
    assert res["decode_bitwise_equal"] and res["container_bytes"] > 0
    assert (tmp_path / "t_decoded.yuv").stat().st_size == 4 * 64 * 64


@pytest.mark.parametrize("make_cfg", [CS.bench_cfg, CS.library_cfg], ids=["ippp", "vbs_fme"])
def test_gop_scan_phase(make_cfg):
    cfg = make_cfg(64, 64, 8)
    cfg.intra_dur = 4
    res = CS.gop_scan(cfg, synthetic_clip(64, 64, 8, seed=0), "t")
    assert res["package_bitwise_equal_per_frame_engine"] and res["decode_bitwise_equal"]


def test_cpu_backend_phase():
    cfg = CS.library_cfg(64, 64, 5)
    clip = synthetic_clip(64, 64, 5, seed=0)
    pkg = JaxCodec(cfg, clip).encode()
    res = CS.cpu_backend(cfg, clip, pkg)
    assert res["frame_types"] == [0, 1, 1]


def test_cpu_backend_phase_detects_a_difference():
    cfg = CS.library_cfg(64, 64, 3)
    clip = synthetic_clip(64, 64, 3, seed=0)
    pkg = JaxCodec(cfg, clip).encode()
    pkg["reconstructed frames"] = pkg["reconstructed frames"].copy()
    pkg["reconstructed frames"][2, 5, 5] ^= 1
    with pytest.raises(AssertionError):
        CS.cpu_backend(cfg, clip, pkg)


@pytest.mark.parametrize("fast", [True, False], ids=["fast_me", "full_search"])
def test_compat_agreement_phase(fast):
    cfg = CS.compat_cfg(fast, h=64, w=64, frames=3, sr=4)
    res = CS.compat_agreement(cfg, synthetic_clip(64, 64, 3, seed=0))
    assert res["frame_types_equal"]
    assert res["min_psnr_gap_db"] > -res["tolerance_db"]
    assert (res["mvs_checked_equal_shared_ref"] > 0) == (not fast)


def test_shared_ref_search_reproduces_the_closed_loop():
    """Given the engine's own reconstructions as references, the shared-
    reference search of phase 4b returns the encode's MVs exactly."""
    cfg = CS.compat_cfg(False, h=64, w=64, frames=4, sr=4)
    clip = synthetic_clip(64, 64, 4, seed=0)
    codec = JaxCodec(cfg, clip)
    pkg = codec.encode()
    fts, rec = pkg["frame_type_seq"], pkg["reconstructed frames"]
    for i in range(1, 4):
        got = CS.shared_ref_mvs(codec, clip, fts, rec, i)
        want = pkg["MVS per Frame"][i]
        assert [(s, tuple(np.ravel(m))) for s, m in got] == \
            [(s, tuple(np.ravel(m))) for s, m in want], i


def test_extreme_blocks_cover_every_basis_sign_pattern():
    x = CS.extreme_blocks(700)
    assert x.shape == (700, 16, 16) and x.dtype == np.int32
    assert set(np.unique(x)) == {-255, 255}
    assert len({b.tobytes() for b in x[:2 + 2 * 256]}) == 2 + 2 * 256 - 2  # DC pattern repeats


def test_transform_probe_phase():
    res = CS.transform_probe(n_blocks=700, timing_blocks=64)
    assert res["bitwise_equal"] and res["qps"] == "0..12"
    assert "fusion_kinds" in res["dct_lowering"]


def test_window_gather_probe_phase():
    res = CS.window_gather_probe(h=64, w=96, nb=48)
    assert res["bitwise_equal"] and len(res["windows"]) == 2


@pytest.mark.gpu
def test_numerics_probes_at_full_width(gpu_only):
    """Phase 5 at its card sizes: only the GPU's matmul precision and its
    integer dot lowering can break these (chip_smoke.py runs them there)."""
    assert CS.transform_probe()["bitwise_equal"]
    assert CS.window_gather_probe()["bitwise_equal"]


def test_cli_phase(tmp_path):
    assert CS.cli(64, 64, 4, out_dir=tmp_path)["returncode"] == 0
    assert (tmp_path / "cli" / "decoded.yuv").stat().st_size == 4 * 64 * 64


def test_four_card_phase_on_virtual_devices():
    res = CS.four_card(64, 64, 4, devices=jax.devices()[:4])
    assert set(res) == {"full_search_vbs_fme", "fast_me_vbs_fme"}
    for r in res.values():
        assert r["mesh"] == "data=2 x tile=2" and r["encode_bitwise_equal_single_card"]


@pytest.mark.parametrize("op_name,stage", [
    ("jit(_inter_step)/fastme_chain/while/body/fastme_window/gather", "fastme_window"),
    ("jit(_inter_step)/fastme_chain/while/body/add", "fastme_chain"),
    ("jit(_decode_inter_step)/pred_gather/int_dct/dot_general", "int_dct"),
    ("jit(f)/add", "other"),
    ("", "other"),
])
def test_trace_stage_of(op_name, stage):
    assert TS.stage_of(op_name) == stage


@pytest.fixture
def cpu_trace(tmp_path):
    """A profiler trace of one jitted function with a named stage, on the CPU."""
    import jax.numpy as jnp

    def f(x):
        with jax.named_scope("full_search"):
            y = jnp.sin(x) @ x
        return y.sum()

    jf = jax.jit(f)
    x = jnp.ones((64, 64))
    jf(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        with jax.profiler.TraceAnnotation("window:w"):
            jf(x).block_until_ready()
    return tmp_path


def test_trace_reduction_on_a_cpu_trace(cpu_trace):
    red = TS.reduce_trace(cpu_trace, frames=1)
    assert TS.op_names('  %fusion.3 = s32[4]{0} fusion(%p), kind=kLoop, '
                       'metadata={op_name="jit(f)/full_search/add"}') == {
        "fusion.3": "jit(f)/full_search/add"}
    assert red["w"]["kernels"] > 0 and 0.0 <= red["w"]["device_idle_share"] <= 1.0
    json.dumps(red)


@pytest.mark.parametrize("backend,error", [("gpu", RuntimeError), ("rocm", ValueError)])
def test_trace_reduction_never_reports_host_events_as_device_time(cpu_trace, backend, error):
    """Under a GPU backend a trace without GPU planes is an error, not a
    fallback to host events."""
    with pytest.raises(error):
        TS.reduce_trace(cpu_trace, frames=1, backend=backend)
