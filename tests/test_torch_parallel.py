"""The port's parallel layer (bioscan_clip_tpu_torch/parallel/) and its
sharded and streamed search (retrieval/engine.py) against the JAX package
on the same numpy inputs:
- `create_mesh` and `shard_batch(_padded)` against JAX parallel/mesh.py
  over as many CPU entries as JAX's virtual devices: the same axis, each
  device's rows equal;
- `maybe_initialize_distributed`'s triggers (a 1-process gloo group, torn
  down after each);
- the sharded search over a mesh of four CPU entries against JAX
  `topk_search(mesh=create_mesh())` on the conftest's 8 virtual devices,
  and slab streaming with a small `max_device_keys` against JAX
  `topk_search(max_device_keys=)`, for fp32 "high" and "default" and for
  int8 under each rescore mode (the bf16 rescore against JAX's resident
  one: JAX's streaming rescores its fp32 stream rows in every mode).

Tolerances: fp32 scores atol 1e-6 (fp32 dots of 64 terms of unit vectors
in another summation order), indices equal wherever neighbouring scores
differ by more than 1e-5 (a closer pair is a near-tie either order may
break); "default" against JAX's fp32 search of operands rounded to bf16
(XLA:CPU does not emulate the bf16 pass; tests/test_torch_topk.py), with
the same bounds; int8 "none" bit for bit (exact integer dots times two
scales in one order), the rescored modes scores 1e-6 and indices equal.
"""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bioscan_clip_tpu.parallel import mesh as jax_mesh
from bioscan_clip_tpu.retrieval import engine as jax_engine
from bioscan_clip_tpu.retrieval.engine import l2norm_np
from bioscan_clip_tpu_torch.config.core import ConfigNode
from bioscan_clip_tpu_torch.parallel import distributed, mesh
from bioscan_clip_tpu_torch.retrieval import engine
from test_torch_topk import _assert_same
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_KEYS, D, BQ, K = 1000, 64, 8, 5


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    keys = l2norm_np(rng.standard_normal((N_KEYS, D)).astype(np.float32))
    keys[900:] = keys[:100]  # ties across shards and slabs
    q = l2norm_np(rng.standard_normal((BQ, D)).astype(np.float32))
    q[0] = keys[3]
    return q, keys


def test_create_mesh_and_shard_batch_match_jax():
    jm = jax_mesh.create_mesh(devices=jax.devices()[:4])
    pm = mesh.create_mesh(devices=["cpu"] * 4)
    assert pm.shape == dict(jm.shape) == {"data": 4}
    assert jm.axis_names == (mesh.DATA_AXIS,) and pm.group is None
    assert mesh.create_mesh({"data": -1}, devices=["cpu"] * 4).size == 4
    with pytest.raises(ValueError, match="!= 4"):
        mesh.create_mesh({"data": 3}, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="'model'"):
        mesh.create_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)

    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((8, 3)).astype(np.float32),
             "tok": {"ids": rng.integers(0, 9, (8, 5)).astype(np.int32)}}
    ref = jax_mesh.shard_batch(batch, jm)
    shards = mesh.shard_batch(batch, pm)
    assert len(shards) == 4
    for leaf, get in (("x", lambda b: b["x"]),
                      ("ids", lambda b: b["tok"]["ids"])):
        jref = get(ref)
        for i, s in enumerate(jref.addressable_shards):
            np.testing.assert_array_equal(get(shards[i]).numpy(),
                                          np.asarray(s.data), err_msg=leaf)
        np.testing.assert_array_equal(
            torch.cat([get(s) for s in shards]).numpy(), np.asarray(jref))
    with pytest.raises(ValueError, match="divisible"):
        mesh.shard_batch({"x": batch["x"][:7]}, pm)

    odd = {"x": batch["x"][:6]}
    ref, n_ref = jax_mesh.shard_batch_padded(odd, jm)
    shards, n = mesh.shard_batch_padded(odd, pm)
    assert n == n_ref == 6
    np.testing.assert_array_equal(
        torch.cat([s["x"] for s in shards]).numpy(), np.asarray(ref["x"]))


@pytest.mark.parametrize("shape,raises", [
    (None, None), ({"data": -1}, None), ({"data": 1}, None),
    ({"data": 4}, "one device"), ({"data": 1, "model": 2}, "'model'")])
def test_mesh_from_config_on_the_cpu(shape, raises):
    """The CLIs' search mesh: the CPU is one device, so `tpu.mesh_shape`
    gives no mesh there (the key set is not split on one CPU) and an axis
    above 1, or another axis, raises."""
    args = ConfigNode({"tpu": {"mesh_shape": shape}})
    if raises:
        with pytest.raises(ValueError, match=raises):
            mesh.mesh_from_config(args, "cpu")
    else:
        assert mesh.mesh_from_config(args, "cpu") is None


def _teardown():
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("trigger", ["config", "env", "auto"])
def test_distributed_triggers(trigger, monkeypatch):
    """First match wins: the `tpu.distributed` dict, the BSCAN_* variables,
    then `auto` (torchrun's env://); nothing asked, one process; a second
    call is a no-op; an incomplete dict or an unknown value raises."""
    for var in ("BSCAN_COORDINATOR", "BSCAN_NUM_PROCESSES",
                "BSCAN_PROCESS_ID", "BSCAN_DISTRIBUTED", "RANK",
                "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert distributed.maybe_initialize_distributed(
        ConfigNode({"tpu": {}}), device="cpu") == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process_id"):
        distributed.maybe_initialize_distributed(ConfigNode(
            {"tpu": {"distributed": {"coordinator": "localhost:1"}}}),
            device="cpu")
    with pytest.raises(ValueError, match="expected"):
        distributed.maybe_initialize_distributed(
            ConfigNode({"tpu": {"distributed": "sometimes"}}), device="cpu")

    addr = f"localhost:{_free_port()}"
    args = ConfigNode({"tpu": {}})
    if trigger == "config":
        args = ConfigNode({"tpu": {"distributed": {
            "coordinator": addr, "num_processes": 1, "process_id": 0}}})
    elif trigger == "env":
        monkeypatch.setenv("BSCAN_COORDINATOR", addr)
        monkeypatch.setenv("BSCAN_NUM_PROCESSES", "1")
        monkeypatch.setenv("BSCAN_PROCESS_ID", "0")
    else:
        args = ConfigNode({"tpu": {"distributed": "auto"}})
        host, port = addr.split(":")
        monkeypatch.setenv("MASTER_ADDR", host)
        monkeypatch.setenv("MASTER_PORT", port)
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
    lines = []
    try:
        assert distributed.maybe_initialize_distributed(
            args, log=lines.append, device="cpu") == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert len(lines) == 1 and "gloo" in lines[0]
        assert distributed.maybe_initialize_distributed(
            args, device="cpu") == (0, 1)  # no-op
        m = mesh.create_mesh()
        assert m.group is not None and m.size == 1
        assert m.devices == (torch.device("cpu"),)
        with pytest.raises(ValueError, match="one device"):
            mesh.create_mesh(devices=["cpu", "cpu"])
        assert distributed.process_device("cpu") == torch.device("cpu")
    finally:
        _teardown()


def _jax_search(q, keys, k, precision, rescore="float32", **kw):
    if precision == "int8":
        pk = jax_engine.PreparedKeys(keys, precision="int8", normalized=True,
                                     rescore=rescore, **kw)
        return jax_engine.topk_search(q, pk, k, _interpret=True)
    if precision == "default":  # bf16 operands, fp32 products
        q, keys = _bf16(q), _bf16(keys)
    return jax_engine.topk_search(q, keys, k, **kw)


def _check(got, ref, precision, rescore):
    sims, idx = got
    assert idx.dtype == np.int64 and sims.shape == (BQ, K)
    if precision == "int8" and rescore == "none":
        np.testing.assert_array_equal(sims.view(np.uint32),
                                      np.asarray(ref[0]).view(np.uint32))
        np.testing.assert_array_equal(idx, ref[1])
    elif precision == "int8":
        np.testing.assert_allclose(sims, ref[0], atol=1e-6)
        np.testing.assert_array_equal(idx, ref[1])
    else:
        _assert_same(sims, idx, *ref)


CASES = [("high", "float32"), ("default", "float32"), ("int8", "float32"),
         ("int8", "bfloat16"), ("int8", "none")]


@pytest.mark.parametrize("precision,rescore", CASES)
def test_sharded_search_matches_jax(data, precision, rescore):
    q, keys = data
    ref = _jax_search(q, keys, K, precision, rescore,
                      mesh=jax_mesh.create_mesh())
    pm = mesh.create_mesh(devices=["cpu"] * 4)
    pk = engine.PreparedKeys(keys, mesh=pm, precision=precision,
                             normalized=True, rescore=rescore)
    assert [sh.n for sh in pk.shards] == [250] * 4
    assert all(sh.keys is not None for sh in pk.shards)
    assert not pk.streaming
    _check(engine.topk_search(q, pk, K), ref, precision, rescore)
    # more shards than a few keys fill: empty shards pad and lose
    small = engine.topk_search(q, keys[:6], K, precision=precision,
                               rescore=rescore,
                               mesh=mesh.create_mesh(devices=["cpu"] * 4))
    whole = engine.topk_search(q, keys[:6], K, device="cpu",
                               precision=precision, rescore=rescore)
    if precision == "int8":
        np.testing.assert_array_equal(small[1], whole[1])
        np.testing.assert_array_equal(small[0], whole[0])
    else:  # the plain products block the keys otherwise
        _assert_same(*small, *whole)


@pytest.mark.parametrize("precision,rescore", CASES)
def test_streamed_search_matches_jax(data, precision, rescore):
    q, keys = data
    # JAX streams the fp32 rows and rescores them whatever the mode
    # (engine.py:114-135); the port streams the codes and keeps the mode's
    # rows, so its bf16 rescore is held to JAX's resident one
    stream = {} if rescore == "bfloat16" else {"max_device_keys": 300}
    ref = _jax_search(q, keys, K, precision, rescore, **stream)
    pk = engine.PreparedKeys(keys, device="cpu", precision=precision,
                             normalized=True, rescore=rescore,
                             max_device_keys=300)
    (sh,) = pk.shards
    assert pk.streaming and sh.slab == 300 and sh.keys is None
    assert [e - s for s, e, _ in sh.slabs()] == [300, 300, 300, 100]
    _check(engine.topk_search(q, pk, K), ref, precision, rescore)
    # sharded and streamed at once: each of 4 shards in slabs of 75
    both = engine.topk_search(
        q, keys, K, precision=precision, rescore=rescore,
        max_device_keys=300, mesh=mesh.create_mesh(devices=["cpu"] * 4))
    _check(both, ref, precision, rescore)
