"""PyTorch port, calibration path vs ``kernels_bench.py`` on the CPU.

- The plain versions of the three chain kernels against a jnp transcription of
  the Pallas kernel bodies. Those bodies are closures inside
  ``kernels_bench.calibrate()`` and cannot be imported, so the transcription
  lives here, with its line references, and runs under ``jax.lax.fori_loop``.
  Compare+select and threshold-sum are exact selects and small-integer sums:
  equal bit for bit. The FMA chain multiplies and adds in both: within 1e-5
  relative (XLA may contract the pair into one FMA, ~2^-24 relative per step
  over 64 steps).
- ``kernels_bench_gpu._sol`` against ``kernels_bench._sol`` on the same
  dictionaries, with the renamed keys mapped.
- The build flags: ``calib`` is compiled with FMA contraction on, ``nn`` and
  ``icp_step`` with it off, and the library name covers the flags.
"""

import copy
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kernels_bench
import kernels_bench_gpu
from elasticreconstruction_tpu_torch.kernels.cuda import build, calib, nn

ITERS, NCH = 64, 8


def _x():
    return np.random.default_rng(0).uniform(0.0, 1.0, (64, 512)).astype(np.float32)


@jax.jit
def _j_fma(x):  # kernels_bench.py:162-171
    def body(_, accs):
        return tuple(a * (1.0 + 1e-7 * (k + 1)) + 1e-7 for k, a in enumerate(accs))

    accs = jax.lax.fori_loop(0, ITERS, body, tuple(x + 1e-5 * k for k in range(NCH)))
    return sum(accs)


@jax.jit
def _j_where(x, y):  # kernels_bench.py:206-218
    def body(k, carry):
        t = 0.5 + 1e-4 * jnp.float32(k)
        return tuple(jnp.where(a > t, y, a) for a in carry)

    accs = jax.lax.fori_loop(0, ITERS, body, tuple(x + 1e-5 * k for k in range(NCH)))
    return sum(accs)


@jax.jit
def _j_threshold_sum(x):  # kernels_bench.py:251-265
    m = x > 0.2

    def body(k, accs):
        t = 0.4 + 1e-4 * jnp.float32(k)
        return tuple(a + (m & (x >= t + 1e-3 * c)).astype(jnp.float32) for c, a in enumerate(accs))

    accs = jax.lax.fori_loop(0, ITERS, body, tuple(x + 1e-5 * k for k in range(NCH)))
    return sum(accs)


def test_fma_chain_matches_kernels_bench_body():
    x = _x()
    got = calib.fma_chain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(_j_fma(jnp.asarray(x))), rtol=1e-5)


def test_where_chain_matches_kernels_bench_body():
    x = _x()
    y = x * np.float32(0.75) + np.float32(0.1)  # kernels_bench.py:233
    got = calib.where_chain(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(_j_where(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size > 1000  # not a constant field
    # Chained as the calibration chains it: each launch on the last output.
    got2 = calib.where_chain(torch.from_numpy(got), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got2, np.asarray(_j_where(jnp.asarray(want), jnp.asarray(y))))


def test_threshold_sum_chain_matches_kernels_bench_body():
    x = _x()
    got = calib.threshold_sum_chain(torch.from_numpy(x)).numpy()
    want = np.asarray(_j_threshold_sum(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    # Both branches of the mask and of the threshold are exercised.
    counts = np.round(got - 8 * x)
    assert counts.min() == 0 and counts.max() == 8 * ITERS
    got2 = calib.threshold_sum_chain(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(got2, np.asarray(_j_threshold_sum(jnp.asarray(want))))


def test_wrappers_check_iters_and_device():
    x = torch.zeros((4, 8))
    assert calib.fma_chain(x, iters=0).shape == x.shape
    with pytest.raises(ValueError, match="multiple of 4"):
        calib.fma_chain(x, iters=6)
    meta = torch.zeros((4, 8), device="meta")
    for call in (lambda: calib.fma_chain(meta), lambda: calib.where_chain(meta, meta),
                 lambda: calib.threshold_sum_chain(meta)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert set(calib.KERNELS) == {"fma_chain", "where_chain", "threshold_sum_chain"}
    assert all(build.launches[name] == 0 for name in calib.KERNELS)  # the CPU route launches nothing


# ---- _sol ------------------------------------------------------------------

PEAK_RENAMES = {  # kernels_bench.py key -> kernels_bench_gpu.py key
    "peak_mxu_f32_tflops": "peak_matmul_f32_tflops",
    "peak_mxu_bf16_tflops": "peak_matmul_bf16_tflops",
    "peak_vpu_tflops": "peak_fp32_fma_tflops",
    "peak_vpu_where_gops": "peak_where_gops",
    "peak_gather_vmem_geps": "peak_gather_l2_geps",
}
MODEL_RENAMES = {
    "vpu_ops": "fp32_ops", "vpu_where_ops": "where_ops", "mxu_flops": "matmul_flops",
    "mxu_bf16_flops": "matmul_bf16_flops", "gathers_vmem": "gathers_l2",
}
TIME_RENAMES = {
    "vpu": "fp32", "vpu_where": "where", "mxu": "matmul", "mxu_bf16": "matmul_bf16",
    "gather_vmem": "gather_l2",
}
J_PEAKS = {
    "peak_bw_gbs": 700.0, "peak_mxu_f32_tflops": 20.0, "peak_mxu_bf16_tflops": 150.0,
    "peak_vpu_tflops": 3.0, "peak_vpu_where_gops": 900.0, "peak_threshold_sum_gops": 1800.0,
    "peak_gather_hbm_geps": 0.12, "peak_gather_vmem_geps": 2.5, "peak_scatter_hbm_geps": 0.3,
}
SOL_CASES = {
    "ops_bound": (0.4, {"hbm_bytes": 1 << 20, "vpu_ops": 4.3e9, "mxu_flops": 3.2e9}),
    "bytes_bound": (3.0, {"hbm_bytes": 2 << 30, "vpu_ops": 1e6}),
    "where_and_bf16": (9.0, {"vpu_ops": 4e9, "vpu_where_ops": 2e9, "mxu_bf16_flops": 1.3e10}),
    "gathers": (700.0, {"vpu_ops": 1e9, "gathers_hbm": 8e7, "gathers_vmem": 1e6, "scatters_hbm": 2.7e6}),
    "threshold_sum": (0.5, {"vpu_ops": 1.6e9, "threshold_sum_ops": 5.5e8, "mxu_flops": 1.3e9}),
    "beats_its_bound": (0.01, {"vpu_ops": 4.3e9}),
    "far_under_its_bound": (1000.0, {"vpu_ops": 4.3e9}),
    "zero_time": (0.0, {"vpu_ops": 1e9}),
}


@pytest.mark.parametrize("case", sorted(SOL_CASES))
@pytest.mark.parametrize("drop_optional", [False, True])
def test_sol_matches_kernels_bench(case, drop_optional):
    time_ms, model = SOL_CASES[case]
    j_peaks = dict(J_PEAKS)
    t_peaks = {PEAK_RENAMES.get(k, k): v for k, v in j_peaks.items()}
    if drop_optional:
        # Peaks an old TPU calibration may lack: kernels_bench._sol then lets
        # their resource cost (almost) nothing, a peak of 1e12. The port's
        # calibration always measures every peak and its _sol requires them.
        for k in ("peak_vpu_where_gops", "peak_scatter_hbm_geps", "peak_threshold_sum_gops"):
            del j_peaks[k]
            t_peaks[PEAK_RENAMES.get(k, k)] = 1e12
    want = kernels_bench._sol({"time_ms": time_ms, "model": copy.deepcopy(model)}, j_peaks)
    got = kernels_bench_gpu._sol(
        {"time_ms": time_ms, "model": {MODEL_RENAMES.get(k, k): v for k, v in model.items()}}, t_peaks
    )
    assert got["sol_ms"] == want["sol_ms"]
    assert got["achieved_frac"] == want["achieved_frac"]
    assert got["bound_by"] == TIME_RENAMES.get(want["bound_by"], want["bound_by"])
    assert got.get("suspect", False) == want.get("suspect", False)
    assert got.get("suspect_note") == want.get("suspect_note")
    want_breakdown = {
        TIME_RENAMES.get(k[:-3], k[:-3]) + "_ms": v for k, v in want["sol_breakdown_ms"].items()
    }
    assert got["sol_breakdown_ms"] == want_breakdown


def test_sol_requires_every_peak():
    peaks = {PEAK_RENAMES.get(k, k): v for k, v in J_PEAKS.items()}
    for key in peaks:
        with pytest.raises(KeyError, match=key):
            kernels_bench_gpu._sol({"time_ms": 1.0, "model": {"fp32_ops": 1e9}},
                                   {k: v for k, v in peaks.items() if k != key})


def test_lane_instruction_counts_follow_the_source():
    """The counts the bounds and shares rest on, per element at 64 iterations:
    8 chains x (1 | 2 | 4) per step, plus 3 per iteration for a shared threshold."""
    assert calib.lane_instructions("fma_chain") == 8 * 64
    assert calib.lane_instructions("where_chain") == (8 * 2 + 3) * 64
    assert calib.lane_instructions("threshold_sum_chain") == (8 * 4 + 3) * 64
    assert calib.lane_instructions("where_chain", calib.UNROLL) == 76
    assert calib.lane_instructions("threshold_sum_chain", calib.UNROLL) == 140


def test_bench_kernels_refuses_unported_sections():
    """Every section of kernels_bench.py is ported; an unknown one is refused."""
    assert kernels_bench_gpu.UNPORTED_SECTIONS == ()
    assert {"nn", "icp", "fuse", "raycast", "fpfh", "voxel"} == set(kernels_bench_gpu.KERNEL_SECTIONS)
    with pytest.raises(ValueError, match="no such section"):
        kernels_bench_gpu.bench_kernels({}, {"mesh"})
    with pytest.raises(SystemExit):
        kernels_bench_gpu.main(["--section", "mesh"])


# ---- build flags -------------------------------------------------------------


def test_build_flags_per_source():
    assert set(build.SOURCES) == {"nn", "icp_step", "raycast", "gn_step", "calib"}
    for name in ("nn", "icp_step", "raycast", "gn_step"):
        flags = build.nvcc_flags(name)
        assert "-fmad=false" in flags and "-fmad=true" not in flags
    flags = build.nvcc_flags("calib")
    assert "-fmad=true" in flags and "-fmad=false" not in flags
    for name in build.SOURCES:
        flags = build.nvcc_flags(name)
        assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
        assert (build.CSRC / f"{name}.cu").exists()


def test_kernel_seam_launches_counts_and_routes(monkeypatch):
    """``build.Kernel`` on a stand-in library: nothing loads before the first
    launch; a launch passes the arguments and the stream, is counted by name
    and by shape, and raises with the kernel's name on a non-zero return; the
    reset clears the registry in place; ``on_card`` routes by device."""
    calls = []

    def er_stand_in(*args):
        calls.append(args)
        return args[0]  # the stand-in returns its first argument as the error code

    lib = types.SimpleNamespace(er_stand_in=er_stand_in)
    loaded, hooked = [], []
    monkeypatch.setattr(build, "load", lambda *names: loaded.append(names) or [lib])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=4321))
    monkeypatch.setattr(build, "launches", dict(build.launches))
    monkeypatch.setattr(build, "launches_by_shape", dict(build.launches_by_shape))
    kernel = build.Kernel("calib", "stand_in", [ctypes.c_int, ctypes.c_float], on_load=hooked.append)
    assert loaded == [] and build.launches["stand_in"] == 0 and build.launches_by_shape["stand_in"] == {}
    kernel(torch.device("cuda", 0), 0, 1.5, shape=(2, 3, 4))
    kernel(torch.device("cuda", 0), 0, 2.5, shape=(2, 3, 4))
    kernel.launch(0, 3.5, 99)
    assert loaded == [("calib",)] and hooked == [lib]
    assert calls == [(0, 1.5, 4321), (0, 2.5, 4321), (0, 3.5, 99)]
    assert er_stand_in.argtypes == [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    assert er_stand_in.restype is ctypes.c_int
    assert build.launches["stand_in"] == 3 and build.launches_by_shape["stand_in"] == {(2, 3, 4): 2}
    with pytest.raises(RuntimeError, match="stand_in: CUDA launch failed with cudaError 700"):
        kernel(torch.device("cuda", 0), 700, 0.0, shape=(2, 3, 4))
    assert build.launches["stand_in"] == 3 and build.launches_by_shape["stand_in"] == {(2, 3, 4): 2}

    registry = build.launches_by_shape["nearest_batch"]
    assert nn.launches_by_shape is registry
    build.reset_launches()
    assert build.launches["stand_in"] == 0 and kernel.by_shape == {}
    assert build.launches_by_shape["stand_in"] is kernel.by_shape
    assert nn.launches_by_shape is build.launches_by_shape["nearest_batch"] is registry and registry == {}

    assert build.on_card(types.SimpleNamespace(device=torch.device("cuda", 0)), "op")
    assert not build.on_card(torch.zeros(1), "op")
    with pytest.raises(ValueError, match="op: unsupported device meta"):
        build.on_card(torch.zeros(1, device="meta"), "op")


def test_library_name_covers_the_flags(monkeypatch):
    before = build.lib_path("calib")
    assert before.parent == build.BUILD_DIR and before.name.startswith("libcalib-")
    monkeypatch.setitem(build.SOURCE_FLAGS, "calib", ("-fmad=false",))
    assert build.lib_path("calib") != before
    assert build.lib_path("nn").name.startswith("libnn-")


def test_loop_body_counts_reads_a_listing():
    sass = """
\t\tFunction : _ZN3foo16fma_chain_kernelEPKfPfli
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                    /* 0x000fe20000000800 */
        /*0090*/                   FFMA R5, R5, 1.5, R6 ;          /* 0x0 */
        /*00a0*/                   FFMA R7, R7, 1.5, R6 ;          /* 0x0 */
        /*00b0*/                   ISETP.GE.AND P0, PT, R0, R3, PT ;
        /*00c0*/              @!P0 BRA 0x90 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
\t\tFunction : _ZN3foo9no_loop_kEPf
        /*0000*/                   EXIT ;
"""
    counts = calib.loop_body_counts(sass)
    assert counts == {"_ZN3foo16fma_chain_kernelEPKfPfli": {"total": 4, "FFMA": 2, "ISETP": 1, "BRA": 1}}
