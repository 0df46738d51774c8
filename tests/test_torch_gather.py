"""G1-G3 of the PyTorch port (ops/cuda/gather_kernel.py) and its
attraction-gather microbenchmark against the JAX package's.

The JAX microbenchmark ``benchmarks/_gather_microbench.py`` is loaded by
path and run unchanged, with three names of its module replaced for the
test: ``pl`` by a shim whose ``pallas_call`` runs the TPU kernel in
interpret mode and records its output, ``timeit`` by one plain call, and
``R`` by the test's window size. Under ``jax.disable_jit()`` the kernels
run eagerly, so the recorded outputs are arrays.

Tolerances. Every output element of the three kernels is a single term (a
gathered value, or a sum with one nonzero term), so the port's plain
versions equal the JAX kernels' outputs exactly. The microbenchmark's sums
over all rows are held to 1e-6 of the sum of the terms' magnitudes: the two
packages sum in float32 in other orders, and a sum that cancels can move
further than 1e-6 of itself (1.8e-6 seen on one coordinate here).
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_threads import worker_threads  # noqa: F401
import torchdr_tpu_torch.ops.cuda.build as build
from torchdr_tpu_torch.benchmarks import gather_microbench as gm
from torchdr_tpu_torch.ops.cuda.gather_kernel import (
    MAX_D,
    bucket_2level,
    bucket_2level_plain,
    bucket_onehot,
    bucket_onehot_plain,
    bucket_take,
    bucket_take_plain,
)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "torchdr_tpu_torch" / "ops" / "csrc"
PLAIN = {"pl_take": bucket_take_plain, "pl_onehot": bucket_onehot_plain,
         "pl_2level": bucket_2level_plain}
PORT_RUN = {"pl_take": gm.run_take, "pl_onehot": gm.run_onehot, "pl_2level": gm.run_2level}


@pytest.fixture
def jax_bench(monkeypatch):
    """The JAX microbenchmark module with ``pl``, ``timeit`` and ``R``
    replaced; ``module.outputs`` collects each kernel's raw output."""
    spec = importlib.util.spec_from_file_location(
        "_jax_gather_microbench", ROOT / "benchmarks" / "_gather_microbench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    outputs = []

    class Interpret:
        BlockSpec = staticmethod(pl.BlockSpec)

        @staticmethod
        def pallas_call(kernel, **kwargs):
            call = pl.pallas_call(kernel, interpret=True, **kwargs)

            def run(*args):
                out = call(*args)
                outputs.append(np.asarray(out))
                return out

            return run

    monkeypatch.setattr(module, "pl", Interpret)
    monkeypatch.setattr(module, "timeit", lambda f, *a, reps=20: f(*a))
    module.outputs = outputs

    def set_window(r):
        monkeypatch.setattr(module, "R", r)

    module.set_window = set_window
    return module


def _bucketed(nb, r, d, c, seed):
    rng = np.random.default_rng(seed)
    Zb = rng.normal(size=(nb, r, d)).astype(np.float32)
    idx = rng.integers(0, r, (nb, 8, c // 8)).astype(np.int32)
    idx[0, 0, :2] = (0, r - 1)  # the window's first and last rows
    return Zb, idx


def _run_jax(jax_bench, name, Zb, idx):
    jax_bench.set_window(Zb.shape[1])
    with jax.disable_jit():
        total = getattr(jax_bench, f"bench_{name}")(jnp.asarray(Zb), jnp.asarray(idx))
    return np.asarray(total), jax_bench.outputs[-1]


@pytest.mark.parametrize("r", [64, 128])
@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("name", ["pl_take", "pl_onehot", "pl_2level"])
def test_plain_matches_jax_kernel_exactly(jax_bench, name, d, r):
    Zb, idx = _bucketed(4, r, d, 256, seed=r + d)
    _, want = _run_jax(jax_bench, name, Zb, idx)
    got = PLAIN[name](torch.from_numpy(Zb), torch.from_numpy(idx)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    gathered = np.take_along_axis(Zb, idx.reshape(4, -1)[:, :, None].astype(np.int64), 1)
    if name == "pl_take":
        assert np.array_equal(got.reshape(gathered.shape), gathered)
    else:  # rounded to bf16: within 2^-8 relative of the rows, and not all of them equal
        assert np.all(np.abs(got - gathered) <= np.abs(gathered) * 2.0**-8)
        assert not np.array_equal(got, gathered)


@pytest.mark.parametrize("name", ["pl_take", "pl_onehot", "pl_2level"])
def test_microbench_sums_match_jax(jax_bench, name):
    """The timed path of each variant (the gather and the sum of its
    output) on the CPU against the JAX function's return."""
    Zb, idx = _bucketed(3, 64, 8, 128, seed=5)
    want, _ = _run_jax(jax_bench, name, Zb, idx)
    got = PORT_RUN[name](torch.from_numpy(Zb), torch.from_numpy(idx)).numpy()
    assert got.shape == want.shape == (8,)
    gathered = np.take_along_axis(Zb, idx.reshape(3, -1)[:, :, None].astype(np.int64), 1)
    magnitude = np.abs(gathered.astype(np.float64)).sum(axis=(0, 1))
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-6 * magnitude)


def test_torch_gather_baseline_matches_jax_xla(jax_bench):
    rng = np.random.default_rng(6)
    Z = rng.normal(size=(500, 2)).astype(np.float32)
    NN = rng.integers(0, 500, (500, 16)).astype(np.int32)
    want = np.asarray(jax_bench.bench_xla(jnp.asarray(Z), jnp.asarray(NN)))
    got = gm.run_torch_gather(torch.from_numpy(Z), torch.from_numpy(NN)).numpy()
    assert got.shape == want.shape == (500, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_microbench_main_on_the_cpu(capsys):
    records = gm.main(device="cpu", n=300, w=8, d=3, r=32, c=64, reps=1)
    assert [r["variant"] for r in records] == ["torch_gather", "take", "onehot", "2level"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4
    for rec in records:
        assert rec["edges"] == 2400 and rec["device"] == "cpu" and rec["ms"] > 0
    for rec in records[1:]:
        nb = 2400 // 64
        assert rec["bound_by"] == "bytes"  # between one row and every row of each window
        assert (4 * nb * (64 + 1 * 3 + 64 * 3) / 3.35e12 * 1e3 < rec["bound_ms"]
                < 4 * nb * (64 + 32 * 3 + 64 * 3) / 3.35e12 * 1e3)
        assert rec["kernel_ms"] > 0 and rec["library_ms"] > 0
    assert [r["variant"] for r in gm.main(["onehot"], device="cpu", n=300, w=8, r=32, c=64,
                                          reps=1)] == ["onehot"]


def test_microbench_rejects_unknown_variants():
    with pytest.raises(ValueError, match="unknown variants"):
        gm.main(["pl_take"], device="cpu", n=10, w=2)


def test_microbench_bound_at_the_full_shape():
    """Ids 83.2 MB, the window rows that uniform ids touch (86.5 % of each
    window's 512) 287.8 MB, rows 665.6 MB: 1.037 GB in 0.309 ms; the
    products' 170 GFLOP take 0.172 ms on the tensor cores, so the bytes
    bound G2 and G3 too."""
    nb = gm.N * gm.W // gm.C
    assert nb == 20_312
    rows = round(nb * gm.R * (1 - (1 - 1 / gm.R) ** gm.C))
    for variant in gm.KERNELS:
        ms, by = gm.bound_ms(nb, gm.R, gm.D, gm.C, rows, variant)
        assert by == "bytes" and ms == pytest.approx(0.3094, abs=1e-4)
    assert 2 * nb * gm.C * gm.R * gm.D / 989e12 * 1e3 == pytest.approx(0.172, abs=1e-3)


def test_touched_rows_counts_each_windows_distinct_rows():
    idx = torch.zeros((3, 8, 4), dtype=torch.int32)  # window 0: row 0 only
    idx[1] = torch.arange(32, dtype=torch.int32).reshape(8, 4)  # window 1: all 32 rows
    idx[2, :, :2], idx[2, :, 2:] = 5, 7  # window 2: two rows
    assert gm.touched_rows(idx, 32) == 1 + 32 + 2
    ms, by = gm.bound_ms(3, 32, 2, 32, 35, "take")
    assert by == "bytes" and ms == pytest.approx(4 * (3 * 32 + 35 * 2 + 3 * 32 * 2) / 3.35e12 * 1e3)


def test_touched_rows_of_uniform_ids_follow_their_expectation():
    """R (1 - (1 - 1/R)^c) distinct rows a window: 86.5 % at the full shape's
    R = 512, c = 1,024."""
    _, idx = gm.make_bucketed(torch.Generator().manual_seed(3), 64 * gm.C)
    share = gm.touched_rows(idx, gm.R) / (64 * gm.R)
    assert share == pytest.approx(1 - (1 - 1 / gm.R) ** gm.C, rel=0.01)


def test_library_call_computes_the_same_function():
    Zb, idx = gm.make_bucketed(torch.Generator().manual_seed(1), 8 * 128, d=5, r=64, c=128)
    for variant, plain in (("take", bucket_take_plain), ("onehot", bucket_onehot_plain),
                           ("2level", bucket_2level_plain)):
        got = torch.gather(*gm.library_args(variant, Zb, idx))
        assert torch.equal(got, plain(Zb, idx).reshape(got.shape))


def test_make_bucketed_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    Zb, idx = gm.make_bucketed(gen, 10_000, d=3, r=40, c=256)
    assert Zb.shape == (39, 40, 3) and Zb.dtype == torch.float32
    assert idx.shape == (39, 8, 32) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 40
    assert Zb.is_contiguous() and idx.is_contiguous()
    Z, NN = gm.make_table(gen, 100, 7)
    assert Z.shape == (100, 2) and Z.dtype == torch.float32
    assert NN.shape == (100, 7) and NN.dtype == torch.int32 and int(NN.max()) < 100
    again = gm.make_bucketed(torch.Generator().manual_seed(0), 10_000, d=3, r=40, c=256)
    assert torch.equal(again[0], Zb) and torch.equal(again[1], idx)


@pytest.mark.parametrize("wrapper", [bucket_take, bucket_onehot, bucket_2level])
def test_wrappers_take_the_plain_version_on_the_cpu(wrapper):
    Zb, idx = _bucketed(2, 64, 3, 40, seed=9)
    Zb, idx = torch.from_numpy(Zb), torch.from_numpy(idx)
    plain = {bucket_take: bucket_take_plain, bucket_onehot: bucket_onehot_plain,
             bucket_2level: bucket_2level_plain}[wrapper]
    before = wrapper.launches
    assert torch.equal(wrapper(Zb, idx), plain(Zb, idx))
    assert wrapper.launches == before  # counts kernel launches only


@pytest.mark.parametrize("nb, c8", [(0, 16), (4, 0)])
@pytest.mark.parametrize("wrapper", [bucket_take, bucket_onehot, bucket_2level])
def test_wrappers_take_empty_inputs(wrapper, nb, c8):
    Zb, idx = torch.zeros((nb, 64, 3)), torch.zeros((nb, 8, c8), dtype=torch.int32)
    out = wrapper(Zb, idx)
    assert out.shape == ((nb, 8, c8, 3) if wrapper is bucket_take else (nb, 8 * c8, 3))


def test_out_of_range_ids_are_clamped_to_the_window():
    Zb = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    idx = torch.zeros((2, 8, 1), dtype=torch.int32)
    idx[0, 0, 0], idx[1, 1, 0] = -5, 99
    out = bucket_take(Zb, idx).reshape(2, 8, 3)
    assert torch.equal(out[0, 0], Zb[0, 0]) and torch.equal(out[1, 1], Zb[1, 3])


@pytest.mark.parametrize("case", [
    "Zb float64", "Zb 2D", "idx int64", "idx not 8 rows", "windows differ", "D > 8", "D = 0",
    "no rows", "Zb not contiguous", "idx not contiguous",
])
@pytest.mark.parametrize("wrapper", [bucket_take, bucket_onehot, bucket_2level])
def test_wrappers_reject_what_the_kernels_do_not_take(wrapper, case):
    Zb = torch.zeros((3, 64, 2))
    idx = torch.zeros((3, 8, 4), dtype=torch.int32)
    if case == "Zb float64":
        Zb = Zb.double()
    elif case == "Zb 2D":
        Zb = Zb[0]
    elif case == "idx int64":
        idx = idx.long()
    elif case == "idx not 8 rows":
        idx = torch.zeros((3, 4, 8), dtype=torch.int32)
    elif case == "windows differ":
        idx = idx[:2]
    elif case == "D > 8":
        Zb = torch.zeros((3, 64, MAX_D + 1))
    elif case == "D = 0":
        Zb = torch.zeros((3, 64, 0))
    elif case == "no rows":
        Zb = torch.zeros((3, 0, 2))
    elif case == "Zb not contiguous":
        Zb = torch.zeros((3, 2, 64)).transpose(1, 2)
    elif case == "idx not contiguous":
        idx = torch.zeros((3, 4, 8), dtype=torch.int32).transpose(1, 2)
    with pytest.raises(ValueError):
        wrapper(Zb, idx)


@pytest.mark.parametrize("grp", [0, 24, 128])
def test_2level_needs_whole_groups(grp):
    Zb, idx = torch.zeros((1, 64, 2)), torch.zeros((1, 8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="R % grp"):
        bucket_2level(Zb, idx, grp=grp)
    with pytest.raises(ValueError, match="R % grp"):
        bucket_2level_plain(Zb, idx, grp=grp)


def test_2level_takes_other_group_sizes():
    Zb, idx = _bucketed(2, 96, 3, 64, seed=4)
    Zb, idx = torch.from_numpy(Zb), torch.from_numpy(idx)
    for grp in (1, 3, 16, 96):
        assert torch.equal(bucket_2level(Zb, idx, grp=grp), bucket_onehot_plain(Zb, idx))


def _source(name):
    return (SRC / f"{name}.cu").read_text()


def test_constants_are_the_sources():
    src = _source("bucket_gather")
    assert "case 8: return LAUNCH<8>" in src and f"d > {MAX_D}" in src


@pytest.mark.parametrize("library", sorted(build.SIGNATURES))
def test_signatures_are_the_sources(library):
    """Each entry point that ``build.py`` binds is an ``extern "C"`` function
    of its library's source, with as many parameters as argtypes."""
    src = _source(library)
    for entry, argtypes in build.SIGNATURES[library].items():
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert m is not None, f"{entry} not in {library}.cu"
        assert len(m.group(1).split(",")) == len(argtypes)


def test_library_hash_covers_the_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-lineinfo"])
    second = build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    third = build.library_path("k")
    assert len({first, second, third}) == 3
    assert first.parent == build.build_dir() and first.name.startswith("libk-")


def test_load_function_names_its_entry_point():
    with pytest.raises(ValueError):  # several entry points: one must be named
        build.load_function("bucket_gather")
