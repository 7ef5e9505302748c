"""The port's ArcLight engine core (``repro_torch.core``: graph, engine,
threads, numa) against the reference's ``repro.core``.

Twins of ``tests/test_core_graph.py`` and
``tests/test_core_threads_numa.py``: the graph builder's modes and
errors on the port, the port's ``Engine`` (nodes run with torch on the
CPU) against the reference's on the same weights — outputs within 1e-5
(f32), equal node and barrier counts and equal weight / activation /
per-node bytes — and the thread manager and NUMA cost model (numpy,
copied) exactly equal to the reference's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro.core.numa as jnuma
import repro.core.threads as jthreads
import repro_torch.core as T
import repro_torch.core.numa as tnuma
import repro_torch.core.threads as tthreads
from repro.core.graph import GraphScheduler as JScheduler
from repro_torch.core.graph import GraphError, GraphScheduler
from repro_torch.core.tensor import OpType, TensorBundle

TOL = 1e-5


def _mlp_weights(d, f, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w_gate": (rng.normal(size=(f, d)) * 0.1).astype(np.float32),
        "w_up": (rng.normal(size=(f, d)) * 0.1).astype(np.float32),
        "w_down": (rng.normal(size=(d, f)) * 0.1).astype(np.float32),
    }


# ----------------------------------------------------------------------
# the static list (A.1)
# ----------------------------------------------------------------------

class TestStaticList:
    def test_append_order_is_topological(self):
        g = T.ForwardGraph()
        x = g.input((4, 2), name="x")
        w = g.weight((8, 4), name="w")
        g.silu(g.gemm(w, x))
        assert g.verify_topological()
        assert g.node_count() == 2
        assert g.order[0].next_index == 1

    def test_scatter_gather_modes(self):
        g = T.ForwardGraph(n_nodes=4)
        xs = g.scatter(g.input((8, 2)), n=4)
        assert len(xs) == 4
        assert all(h.op is OpType.SCATTER for h in xs)
        ws = TensorBundle([g.weight((3, 8), node_id=i).single
                           for i in range(4)])
        ys = g.gemm(ws, xs)
        assert len(ys) == 4
        z = g.gather(ys, mode="concat", axis=0)
        assert z.single.shape == (12, 2)
        assert g.verify_topological()

    def test_gather_requires_parallel_bundle(self):
        g = T.ForwardGraph()
        with pytest.raises(GraphError):
            g.gather(g.input((4, 2)))

    def test_scatter_axis_divisibility(self):
        g = T.ForwardGraph(n_nodes=3)
        with pytest.raises(GraphError):
            g.scatter(g.input((8, 2)), n=3, axis=0)

    def test_bundle_single_enforcement(self):
        g = T.ForwardGraph(n_nodes=2)
        xs = g.scatter(g.input((4, 2)), n=2)
        with pytest.raises(ValueError):
            _ = xs.single


# ----------------------------------------------------------------------
# execution against the reference
# ----------------------------------------------------------------------

def _both_engines(n_nodes, d, f, t, **cfg):
    out = []
    for pkg, extra in ((J, {}), (T, {"device": "cpu"})):
        eng = pkg.Engine(pkg.EngineConfig(n_nodes=n_nodes, **cfg, **extra))
        _, z = pkg.build_tp_mlp_graph(eng, d, f, t)
        out.append((eng, z))
    return out


@pytest.mark.parametrize("n_nodes", [1, 2, 4])
def test_engine_matches_the_reference_engine(n_nodes):
    d, f, t = 16, 32, 5
    w = _mlp_weights(d, f)
    x = np.random.default_rng(1).normal(size=(d, t)).astype(np.float32)
    weights = dict(w) if n_nodes == 1 else T.split_mlp_weights(w, n_nodes)
    (jeng, jz), (teng, tz) = _both_engines(n_nodes, d, f, t, n_threads=8)
    jrep = jeng.execute({"x": x}, weights)
    trep = teng.execute({"x": x}, weights)
    np.testing.assert_allclose(trep.outputs[tz.single.name].numpy(),
                               np.asarray(jrep.outputs[jz.single.name]),
                               rtol=TOL, atol=TOL)
    y = np.asarray(jnp.asarray(w["w_gate"] @ x))
    ref = w["w_down"] @ (y / (1 + np.exp(-y)) * (w["w_up"] @ x))
    np.testing.assert_allclose(trep.outputs[tz.single.name].numpy(), ref,
                               rtol=1e-4, atol=TOL)
    assert trep.node_count == jrep.node_count
    assert trep.barrier_count == jrep.barrier_count == trep.node_count

    def by_shape(rep):      # tensor names carry a process-wide counter
        return sorted(rep.weight_bytes.values()), sorted(
            rep.activation_bytes.values())

    assert by_shape(trep) == by_shape(jrep)
    assert trep.per_node_bytes == jrep.per_node_bytes


def test_numa_memory_isolation_matches_the_reference():
    (jeng, _), (teng, _) = _both_engines(4, 16, 32, 2, n_threads=8,
                                         numa=True)
    jeng.plan()
    teng.plan()
    per_node = teng.memory.per_node_bytes()
    assert set(per_node) == {0, 1, 2, 3}
    assert per_node == jeng.memory.per_node_bytes()
    node_w = [v for k, v in teng.memory.weight_bytes().items()
              if "node" in k]
    assert len(set(node_w)) == 1
    assert teng.memory.weight_bytes() == jeng.memory.weight_bytes()


@pytest.mark.parametrize("pos", [3, 7])
def test_kv_cache_ops_match_the_reference(pos):
    """kv_set at ``pos`` (7: past the room left, the start clamps as
    ``dynamic_update_slice`` clamps it), then kv_get."""
    got = {}
    for name, pkg, sched in (("ref", J, JScheduler),
                             ("port", T, GraphScheduler)):
        g = pkg.ForwardGraph()
        g.kv_create("k0", (1, 8, 4))
        val = g.input((1, 2, 4), name="v")
        p = g.input((), np.int32, name="p")
        g.kv_set("k0", val, p)
        kv = g.kv_get("k0")
        kw = {"device": "cpu"} if pkg is T else {}
        out = sched(g, **kw).run(
            {"v": np.arange(8, dtype=np.float32).reshape(1, 2, 4) + 1,
             "p": np.asarray(pos, np.int32)}, {})
        got[name] = np.asarray(out[kv.single.name])
    np.testing.assert_array_equal(got["port"], got["ref"])
    assert got["port"].sum() == 36.0


def test_every_op_matches_the_reference():
    """One graph with each op the builder emits outside the MLP helper:
    embed, rmsnorm, reshape, transpose, softmax, gelu, add, copy, and a
    scatter along an axis gathered back by concatenation."""
    rng = np.random.default_rng(2)
    inputs = {"ids": np.array([3, 1, 4, 1], np.int32)}
    weights = {"table": rng.normal(size=(6, 8)).astype(np.float32),
               "gain": rng.normal(size=(8,)).astype(np.float32)}
    got = {}
    for pkg, sched in ((J, JScheduler), (T, GraphScheduler)):
        g = pkg.ForwardGraph(n_nodes=2)
        ids = g.input((4,), np.int32, name="ids")
        e = g.embed(g.weight((6, 8), name="table"), ids)
        h = g.rmsnorm(e, g.weight((8,), name="gain"), eps=1e-6)
        h = g.transpose(g.reshape(h, (4, 2, 4)), (1, 0, 2))
        s = g.add(g.gelu(g.softmax(h, axis=-1)), g.copy(h))
        parts = g.scatter(g.reshape(s, (8, 4)), n=2, axis=0)
        z = g.gather(g.silu(parts), mode="concat", axis=0)
        kw = {"device": "cpu"} if pkg is T else {}
        got[pkg] = np.asarray(sched(g, **kw).run(inputs, weights)[
            z.single.name])
    np.testing.assert_allclose(got[T], got[J], rtol=TOL, atol=TOL)


def test_scheduler_reports_missing_inputs():
    g = T.ForwardGraph()
    g.silu(g.input((2,), name="x"))
    with pytest.raises(GraphError, match="missing graph input"):
        GraphScheduler(g, device="cpu").run({}, {})


# ----------------------------------------------------------------------
# thread manager and NUMA cost model: copied, exactly equal
# ----------------------------------------------------------------------

@pytest.mark.parametrize("binding", ["distribute", "isolate"])
def test_thread_pool_matches_the_reference(binding):
    for n_threads, n_nodes, groups in ((8, 4, 4), (6, 2, 2), (7, 4, 3)):
        jp = jthreads.ThreadPool(n_threads, n_nodes=n_nodes,
                                 binding=binding)
        tp_ = tthreads.ThreadPool(n_threads, n_nodes=n_nodes,
                                  binding=binding)
        assert tp_.affinity == jp.affinity
        assert ([dataclasses.astuple(g) for g in tp_.split(groups)]
                == [dataclasses.astuple(g) for g in jp.split(groups)])
        assert (tp_.group_of(1).group_id == jp.group_of(1).group_id)
        assert dataclasses.astuple(tp_.merge()) == dataclasses.astuple(
            jp.merge())


def test_sync_schedules_match_the_reference():
    rng = np.random.default_rng(0)
    for d in ([[2.0, 0.5], [0.5, 2.0]], [[1.0, 1.0], [1.0, 1.0]],
              rng.uniform(0.01, 10.0, size=(4, 6)).tolist()):
        for mode in ("sync_a", "sync_b"):
            for cost in (0.0, 0.3):
                assert (dataclasses.asdict(
                    getattr(tthreads.SyncSchedule, mode)(d, cost))
                    == dataclasses.asdict(
                        getattr(jthreads.SyncSchedule, mode)(d, cost)))
        assert (tthreads.SyncSchedule.speedup(d)
                == jthreads.SyncSchedule.speedup(d))


def test_numa_topology_and_traffic_match_the_reference():
    np.testing.assert_array_equal(
        tnuma.KUNPENG_920_4NODE.bandwidth_matrix(),
        jnuma.KUNPENG_920_4NODE.bandwidth_matrix())
    assert (dataclasses.asdict(tnuma.KUNPENG_920_4NODE)
            == dataclasses.asdict(jnuma.KUNPENG_920_4NODE))
    for attr in ("n_params", "weight_bytes", "decode_flops", "head_dim"):
        assert getattr(tnuma.QWEN3_4B, attr) == getattr(jnuma.QWEN3_4B,
                                                        attr)
    assert (tnuma.QWEN3_4B.gemm_input_dims()
            == jnuma.QWEN3_4B.gemm_input_dims())


def test_headline_claims_match_the_reference():
    assert tnuma.headline_gain() == jnuma.headline_gain()
    assert (tnuma.async_gain_tokens_per_s()
            == jnuma.async_gain_tokens_per_s())
    assert 0.40 <= tnuma.headline_gain() <= 0.52


@pytest.mark.parametrize("fig", ["fig10_single_node", "fig11_multi_node",
                                 "fig12_13_long_prompt"])
def test_figures_match_the_reference(fig):
    assert getattr(tnuma, fig)() == getattr(jnuma, fig)()


@pytest.mark.parametrize("policy,nodes", [
    ("llama_uma_isolate", 1), ("arclight_single", 1),
    ("llama_uma_distribute", 4), ("arclight_numa_tp", 4)])
def test_throughput_models_match_the_reference(policy, nodes):
    for threads in (12, 48, 192):
        for sync_mode in ("sync_a", "sync_b"):
            args = (threads, nodes, policy)
            kw = {"sync_mode": sync_mode}
            assert dataclasses.asdict(tnuma.decode_throughput(
                tnuma.QWEN3_4B, tnuma.KUNPENG_920_4NODE, *args, **kw)) \
                == dataclasses.asdict(jnuma.decode_throughput(
                    jnuma.QWEN3_4B, jnuma.KUNPENG_920_4NODE, *args, **kw))
            assert dataclasses.asdict(tnuma.prefill_throughput(
                tnuma.QWEN3_4B, tnuma.KUNPENG_920_4NODE, *args, **kw)) \
                == dataclasses.asdict(jnuma.prefill_throughput(
                    jnuma.QWEN3_4B, jnuma.KUNPENG_920_4NODE, *args, **kw))
