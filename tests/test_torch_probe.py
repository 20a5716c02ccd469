"""The top-k decomposition probe's kernels and tool against the JAX
package's, on the CPU:
- `mm_only_reference` (K6's plain version) against the JAX control
  `_mm_only_kernel` of tools/bench_topk_variants.py, run through
  `pl.pallas_call(..., interpret=True)` with the JAX script's grid spec:
  fp32 in "high" precision within 1e-5 (fp32 sums over 64 products in
  another order), int8 bit for bit (both sum exact integer products in
  fp32: 64 * 127^2 < 2^24);
- "default" precision, the TPU's single bf16 pass, which XLA:CPU does not
  emulate: against `_mm_only_kernel` at HIGHEST precision on operands
  already rounded to bf16, and against float64 products of those operands
  (1e-5 each);
- the int8 row quantizer against the JAX `quantize_rows_i8`, bit for bit;
- `tiny_reference` (K7's) against `_tiny_kernel` in interpret mode, exact;
- the port's probe tool on the CPU: its rows, in order, and their keys.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bioscan_clip_tpu_torch.ops import topk as topk_ops
from bioscan_clip_tpu_torch.tools import bench_topk_variants as probe
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
BQ, D, N, TILE, Q_BLOCK = 16, 64, 64, 16, 8


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX script as a module (its kernels, unedited)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_topk_variants", ROOT / "tools" / "bench_topk_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_mm_only(mod, queries, keys, n_valid, precision, int8):
    """`mm_only`'s pallas_call (bench_topk_variants.py:78-110) with
    interpret=True."""
    bq, d = queries.shape
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(bq // Q_BLOCK, keys.shape[0] // TILE),
        in_specs=[
            pl.BlockSpec((Q_BLOCK, d), lambda qi, t, nv: (qi, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((TILE, d), lambda qi, t, nv: (t, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((Q_BLOCK, 128), lambda qi, t, nv: (qi, 0),
                               memory_space=pltpu.VMEM),
    )
    kernel = functools.partial(
        mod._mm_only_kernel, tile=TILE, int8=int8,
        precision=(jax.lax.Precision.DEFAULT if precision == "default"
                   else jax.lax.Precision.HIGHEST))
    out = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((bq, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray([n_valid], jnp.int32), jnp.asarray(queries),
      jnp.asarray(keys))
    return np.asarray(out)


@pytest.mark.parametrize("n_valid", [N, 41])
def test_mm_only_plain_fp32_matches_jax(jax_probe, n_valid):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((BQ, D)).astype(np.float32)
    k = rng.standard_normal((N, D)).astype(np.float32)
    ref = _jax_mm_only(jax_probe, q, k, n_valid, "high", False)
    calls = topk_ops.mm_only_reference.calls
    out = topk_ops.mm_only(torch.from_numpy(q), torch.from_numpy(k), n_valid)
    assert topk_ops.mm_only_reference.calls == calls + 1
    assert out.shape == (BQ, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    want = (q.astype(np.float64) @ k[:n_valid].T.astype(np.float64)).max(1)
    np.testing.assert_allclose(out.numpy(), np.repeat(want[:, None], 128, 1),
                               atol=1e-5)


@pytest.mark.parametrize("n_valid", [N, 23])
def test_mm_only_plain_int8_bit_equal_to_jax(jax_probe, n_valid):
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, size=(BQ, D)).astype(np.int8)
    k = rng.integers(-127, 128, size=(N, D)).astype(np.int8)
    k[5] = 127  # large dots: exact as integers in fp32
    ref = _jax_mm_only(jax_probe, q, k, n_valid, "default", True)
    out = topk_ops.mm_only(torch.from_numpy(q), torch.from_numpy(k), n_valid,
                           int8=True)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_mm_only_default_precision_rounds_operands_to_bf16(jax_probe):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((BQ, D)).astype(np.float32)
    k = rng.standard_normal((N, D)).astype(np.float32)
    out = topk_ops.mm_only(torch.from_numpy(q), torch.from_numpy(k), N,
                           precision="default")

    def bf16(x):
        return torch.from_numpy(x).bfloat16().float().numpy()

    ref = _jax_mm_only(jax_probe, bf16(q), bf16(k), N, "high", False)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    want = (bf16(q).astype(np.float64) @ bf16(k).T.astype(np.float64)).max(1)
    np.testing.assert_allclose(out[:, 0].numpy(), want, atol=1e-5)
    high = topk_ops.mm_only(torch.from_numpy(q), torch.from_numpy(k), N)
    assert not torch.equal(out, high)


def test_mm_only_edges_and_arguments():
    q = torch.ones(3, 32)
    k = torch.ones(10, 32)
    assert torch.isneginf(topk_ops.mm_only(q, k, 0)).all()
    with pytest.raises(ValueError, match="precision"):
        topk_ops.mm_only(q, k, 10, precision="highest")
    with pytest.raises(ValueError, match="n_valid"):
        topk_ops.mm_only(q, k, 11)


def test_tiny_plain_matches_jax(jax_probe):
    x = np.random.default_rng(3).standard_normal((8, 128)).astype(np.float32)
    ref = pl.pallas_call(
        jax_probe._tiny_kernel,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(jnp.asarray(x))
    calls = topk_ops.tiny_reference.calls
    out = topk_ops.tiny(torch.from_numpy(x))
    assert topk_ops.tiny_reference.calls == calls + 1
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_quantize_on_the_device_bit_equal_to_jax():
    from bioscan_clip_tpu.ops.topk_pallas import quantize_rows_i8

    x = np.random.default_rng(4).standard_normal((50, 64)).astype(np.float32)
    x[7] = 0.0
    x[8, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]  # scale 1: halves to even
    x[8, 5:] = 0.0
    codes, scales = topk_ops.quantize_rows_i8_torch(torch.from_numpy(x))
    ref_c, ref_s = quantize_rows_i8(x)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  np.asarray(ref_s)[:, 0].view(np.uint32))
    assert codes[8, :5].tolist() == [127, 0, 2, 2, -2]


def test_probe_rows_on_the_cpu(tmp_path):
    """The port's probe at a tiny size on the CPU (plain versions, host
    clock): the JAX script's variants in its order, one JSON object per
    row on stdout and, with --out, appended to that file."""
    lines = []
    out = tmp_path / "rows.jsonl"
    argv = ["--device", "cpu", "--keys", "300", "--queries", "8", "--dim",
            "64", "--bq", "1,8", "--iters", "2", "--out", str(out)]
    assert probe.main(argv, emit=lines.append) == 0
    rows = [json.loads(ln) for ln in lines]
    assert out.read_text().splitlines() == lines
    assert [r["variant"] for r in rows] == ["dispatch_floor"] + [
        "mm_only_f32", "mm_only_f32", "topk_f32", "mm_only_i8",
        "topk_i8"] * 2
    assert set(rows[0]) == {"device", "keys", "dim", "variant", "ms",
                            "host_ms"}
    common = {"device", "keys", "dim", "queries", "tiling", "tiles",
              "variant", "ms", "us_per_tile"}
    for r in rows[1:]:
        assert common <= set(r), r
        assert r["device"] == "cpu" and r["keys"] == 300
        assert r["ms"] >= 0
    assert [r["precision"] for r in rows[1:3]] == ["default", "high"]
    assert rows[3]["k"] == 5 and rows[5]["k"] == 21
    assert [r["queries"] for r in rows[1::5]] == [1, 8]
    assert rows[1]["tiles"] == 3  # one query block x ceil(300 / 128) tiles
