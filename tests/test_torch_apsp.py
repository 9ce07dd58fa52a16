"""The port's all-pairs matrix (openr_tpu_torch/apsp/) against the JAX
package's (openr_tpu/apsp/), on the CPU.

Per kernel: the plain PyTorch versions `_mp`, `_fw_close_plain`,
`_fw_seed_plain` and `_fw_reclose_plain` (reached through their wrappers,
which take them for CPU tensors) against the JAX `_mp`, `_fw_solver`,
`_fw_seed_solver` and `_fw_reclose_solver`, output by output, with
overloaded nodes, padding slots and nb = 1, 2 and 4 blocks. Per module:
`ApspState(device="cpu")` against the reference's `ApspState` through the
same event sequences (the reference's TOPOLOGIES and a 500-node WAN): equal
matrices, close counts and re-close rounds after every event. Exact
equality throughout.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.apsp import ApspState as JApspState
from openr_tpu.apsp import kernels as jk
from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.ops.graph import compile_graph as j_compile_graph
from openr_tpu.ops.graph import refresh_graph as j_refresh_graph
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch.apsp import ApspState
from openr_tpu_torch.apsp import kernels as tk
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.ops.graph import INF, compile_graph, refresh_graph
from openr_tpu_torch.topology import build_adj_dbs as t_build_adj_dbs
from openr_tpu_torch.topology import grid_edges, wan_edges
from test_apsp import TOPOLOGIES
from test_torch_memory import release_memory_around_each_test  # noqa: F401

# per-state attributes the two packages must agree on after every event
_STATE_ATTRS = (
    "closes", "warm_closes", "cold_closes", "fallback_closes",
    "invalidations", "audit_runs", "audit_mismatches",
    "reclose_rounds_last", "h2d_bytes", "d2h_bytes", "backend",
    "stale_reason",
)



def random_weights(rng, n_pad, degree=4.0, ov_frac=0.05):
    """A direct-edge matrix with INF holes and a 0 diagonal, and an
    overload mask."""
    w = np.full((n_pad, n_pad), INF, dtype=np.int32)
    mask = rng.random((n_pad, n_pad)) < degree / n_pad
    w[mask] = rng.integers(1, 50, size=int(mask.sum()))
    np.fill_diagonal(w, 0)
    ov = rng.random(n_pad) < ov_frac
    return w, ov


def weight_event(rng, w, n_inc, n_dec, n_inf):
    """Raise n_inc present edges (n_inf of them to INF) and lower n_dec:
    (w_new, [(u, v, old)] increases)."""
    present = np.argwhere((w < INF) & (w > 0))
    pick = present[rng.choice(len(present), n_inc + n_dec, replace=False)]
    w_new = w.copy()
    inc = []
    for i, (u, v) in enumerate(pick):
        if i < n_inc:
            inc.append((int(u), int(v), int(w[u, v])))
            w_new[u, v] = INF if i < n_inf else w[u, v] + rng.integers(1, 30)
        else:
            w_new[u, v] = max(1, w[u, v] - rng.integers(1, 30))
    return w_new, inc


def slot_arrays(inc, p, extra=()):
    """Padded increase slots: u = 1 << 30 in the padding; `extra` slots
    (u, v, w) go after the real ones (out-of-range u or v, clipped)."""
    iu = np.full(p, tk.INCREASE_PAD, dtype=np.int32)
    iv = np.zeros(p, dtype=np.int32)
    iw = np.zeros(p, dtype=np.int32)
    for i, (u, v, old) in enumerate([*inc, *extra]):
        iu[i], iv[i], iw[i] = u, v, old
    return iu, iv, iw


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# -- kernels ----------------------------------------------------------------


@pytest.mark.parametrize("bsz", [8, 32, 128])
def test_mp_matches_jax(bsz):
    rng = np.random.default_rng(bsz)
    a = rng.integers(0, 200, size=(3, bsz, bsz)).astype(np.int32)
    b = rng.integers(0, 200, size=(3, bsz, bsz)).astype(np.int32)
    a[rng.random(a.shape) < 0.3] = INF
    b[rng.random(b.shape) < 0.3] = INF
    a[0] = INF  # a whole tile unreachable: the clamp holds the sentinel
    got = tk._mp(t(a), t(b)).numpy()  # batched over the leading axis
    for i in range(3):
        want = np.array(jk._mp(jnp.asarray(a[i]), jnp.asarray(b[i])))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(tk._mp(t(a[i]), t(b[i])).numpy(), want)
    assert got[0].min() == INF


def test_mp_walks_k_in_chunks(monkeypatch):
    """The chunked K walk of the plain product gives the one-shot answer."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 90, size=(16, 40)).astype(np.int32)
    b = rng.integers(0, 90, size=(40, 24)).astype(np.int32)
    want = (a[:, :, None] + b[None, :, :]).min(axis=1)
    monkeypatch.setattr(tk, "_MP_CHUNK", 16 * 24 * 3)  # 3 m a chunk
    np.testing.assert_array_equal(tk._mp(t(a), t(b)).numpy(), want)


@pytest.mark.parametrize("n_pad", [8, 32, 256, 512])
def test_fw_close_matches_jax(n_pad):
    rng = np.random.default_rng(n_pad)
    w, ov = random_weights(rng, n_pad, ov_frac=0.1)
    allow = tk.build_allow_matrix(ov)
    nb, bsz = jk.fw_block_shape(n_pad)
    d_j, probe_j = jk._fw_solver((nb, bsz))(jnp.asarray(w), jnp.asarray(allow))
    w_t = t(w)
    d_t, probe_t = tk.fw_close(w_t, t(allow))
    np.testing.assert_array_equal(d_t.numpy(), np.array(d_j))
    assert int(probe_t) == int(probe_j)
    np.testing.assert_array_equal(d_t.numpy(), tk.np_floyd_warshall(w, ov))
    np.testing.assert_array_equal(w_t.numpy(), w)  # w is not modified


def test_fw_close_mask_matters():
    """An overloaded node relays nothing: the masked close differs from the
    unmasked one, so a close that ignored the mask would fail above."""
    w = np.full((8, 8), INF, dtype=np.int32)
    np.fill_diagonal(w, 0)
    for a, b in ((0, 1), (1, 2)):
        w[a, b] = w[b, a] = 1
    ov = np.zeros(8, dtype=bool)
    ov[1] = True
    d, _ = tk.fw_close(t(w), t(tk.build_allow_matrix(ov)))
    d_open, _ = tk.fw_close(t(w), t(tk.build_allow_matrix(~ov & ov)))
    assert int(d[0, 2]) == INF and int(d_open[0, 2]) == 2
    assert int(d[1, 2]) == 1  # the overloaded node still sources


@pytest.mark.parametrize("n_pad", [32, 256, 512])
def test_fw_seed_matches_jax(n_pad):
    rng = np.random.default_rng(n_pad + 1)
    w, ov = random_weights(rng, n_pad)
    d_prev = tk.np_floyd_warshall(w, ov)
    w_new, inc = weight_event(rng, w, 10, 5, 3)
    # a slot with v out of range (clipped to n - 1) and one with a
    # negative u (clipped to 0, still valid), then the padding slots
    extra = [(3, n_pad + 7, 5), (-4, 2, 1)]
    p = 16
    iu, iv, iw = slot_arrays(inc, p, extra)
    nb, bsz = jk.fw_block_shape(n_pad)
    want = jk._fw_seed_solver((nb, bsz, p))(
        jnp.asarray(d_prev), jnp.asarray(w_new), jnp.asarray(iu),
        jnp.asarray(iv), jnp.asarray(iw),
    )
    got = tk.fw_seed(t(d_prev), t(w_new), t(iu), t(iv), t(iw), nb, bsz)
    np.testing.assert_array_equal(got[0].numpy(), np.array(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.array(want[1]))
    assert int(got[2]) == int(want[2]) > 0


def test_fw_seed_padding_slots_drop():
    """A slot with u = 1 << 30 drops (no row is reset by it), where the
    same slot with u in range resets every row it reaches."""
    rng = np.random.default_rng(9)
    w, ov = random_weights(rng, 32, ov_frac=0.0)
    d_prev = tk.np_floyd_warshall(w, ov)
    u, v = map(int, np.argwhere((w < INF) & (w > 0))[0])
    pad = slot_arrays([], 8)
    live = slot_arrays([(u, v, int(w[u, v]))], 8)
    d0_pad, dirty_pad, num_pad = tk.fw_seed(t(d_prev), t(w), *map(t, pad),
                                            1, 32)
    d0_live, _, num_live = tk.fw_seed(t(d_prev), t(w), *map(t, live), 1, 32)
    np.testing.assert_array_equal(d0_pad.numpy(), d_prev)
    assert int(num_pad) == 0 and not bool(dirty_pad.any())
    assert int(num_live) == 1 and int((d0_live.numpy() == INF).sum()) > int(
        (d_prev == INF).sum())


@pytest.mark.parametrize("n_pad", [256, 512])
def test_fw_reclose_rounds_match_jax(n_pad):
    """Every round's matrix, dirty set and counts equal the reference's."""
    rng = np.random.default_rng(n_pad + 2)
    w, ov = random_weights(rng, n_pad)
    allow = tk.build_allow_matrix(ov)
    d_prev = tk.np_floyd_warshall(w, ov)
    w_new, inc = weight_event(rng, w, 20, 8, 6)
    p = 32
    iu, iv, iw = slot_arrays(inc, p)
    nb, bsz = jk.fw_block_shape(n_pad)
    d_j, dirty_j, num_j = jk._fw_seed_solver((nb, bsz, p))(
        jnp.asarray(d_prev), jnp.asarray(w_new), jnp.asarray(iu),
        jnp.asarray(iv), jnp.asarray(iw),
    )
    d_t, dirty_t, num_t = tk.fw_seed(t(d_prev), t(w_new), t(iu), t(iv),
                                     t(iw), nb, bsz)
    allow_t = t(allow)
    nd, rounds = int(num_j), 0
    assert nd > 0
    while nd:
        kb = min(1 << (nd - 1).bit_length(), nb)
        d_j, dirty_j, num_j, changed_j = jk._fw_reclose_solver((nb, bsz, kb))(
            d_j, jnp.asarray(allow), dirty_j
        )
        d_t, dirty_t, counts = tk.fw_reclose(d_t, allow_t, dirty_t, nb, bsz,
                                             kb)
        rounds += 1
        np.testing.assert_array_equal(d_t.numpy(), np.array(d_j))
        np.testing.assert_array_equal(dirty_t.numpy(), np.array(dirty_j))
        assert counts.tolist() == [int(num_j), int(changed_j)]
        if int(changed_j) == 0:
            break
        nd = int(num_j)
    assert rounds >= 2
    np.testing.assert_array_equal(d_t.numpy(),
                                  tk.np_floyd_warshall(w_new, ov))


def test_fw_reclose_compaction_fill():
    """nonzero(size=kb, fill_value=nb): ascending, filled with nb."""
    dirty = torch.tensor([False, True, False, True])
    assert tk._compact_blocks(dirty, 4, 4).tolist() == [1, 3, 4, 4]
    assert tk._compact_blocks(dirty, 4, 1).tolist() == [1]


def test_host_half_matches_jax():
    j_ls, t_ls = JLinkState("0"), TLinkState("0")
    edges = wan_edges(40, degree=3, seed=2)
    for db in j_build_adj_dbs(edges, overloaded_nodes={"w3"}).values():
        j_ls.update_adjacency_database(db)
    for db in t_build_adj_dbs(edges, overloaded_nodes={"w3"}).values():
        t_ls.update_adjacency_database(db)
    jg, tg = j_compile_graph(j_ls), compile_graph(t_ls)
    w = tk.build_weight_matrix(tg)
    np.testing.assert_array_equal(w, jk.build_weight_matrix(jg))
    np.testing.assert_array_equal(tk.build_allow_matrix(tg.overloaded),
                                  jk.build_allow_matrix(jg.overloaded))
    np.testing.assert_array_equal(tk.np_floyd_warshall(w, tg.overloaded),
                                  jk.np_floyd_warshall(w, jg.overloaded))
    for n_pad in (8, 128, 512):
        assert tk.fw_block_shape(n_pad) == jk.fw_block_shape(n_pad)
    x = np.arange(256 * 256, dtype=np.int32).reshape(256, 256)
    np.testing.assert_array_equal(tk._to_blocks(x, 2, 128),
                                  jk._to_blocks(x, 2, 128))
    np.testing.assert_array_equal(
        tk._from_blocks(tk._to_blocks(x, 2, 128), 2, 128), x)
    assert (tk._FW_BLOCK, tk._APSP_PATCH_SLOTS) == (
        jk._FW_BLOCK, jk._APSP_PATCH_SLOTS)


# -- ApspState against the reference's --------------------------------------


class StatePair:
    """One topology, one LSDB and one ApspState per package."""

    def __init__(self, edges, max_nodes=4096, **kw):
        self.dbs = {"jax": j_build_adj_dbs(edges),
                    "port": t_build_adj_dbs(edges)}
        self.ls = {"jax": JLinkState("0"), "port": TLinkState("0")}
        for name, ls in self.ls.items():
            for db in self.dbs[name].values():
                ls.update_adjacency_database(db)
        self.graph = {"jax": j_compile_graph(self.ls["jax"]),
                      "port": compile_graph(self.ls["port"])}
        self.state = {"jax": JApspState(max_nodes, **kw),
                      "port": ApspState(max_nodes, device="cpu", **kw)}

    def ensure(self):
        self.graph = {
            "jax": j_refresh_graph(self.graph["jax"], self.ls["jax"]),
            "port": refresh_graph(self.graph["port"], self.ls["port"]),
        }
        got = {n: s.ensure(self.graph[n]) for n, s in self.state.items()}
        assert got["port"] == got["jax"]
        js, ts = self.state["jax"], self.state["port"]
        if got["port"]:
            np.testing.assert_array_equal(ts.d, js.d)
        for attr in _STATE_ATTRS:
            assert getattr(ts, attr) == getattr(js, attr), attr
        assert ts.health() == js.health()
        return got["port"]

    def _replace(self, node, fn):
        for name in self.dbs:
            self.dbs[name][node] = fn(self.dbs[name][node])
            self.ls[name].update_adjacency_database(self.dbs[name][node])

    def set_adj(self, a, b, **changes):
        self._replace(a, lambda db: dataclasses.replace(db, adjacencies=[
            dataclasses.replace(adj, **changes)
            if adj.other_node_name == b else adj
            for adj in db.adjacencies
        ]))

    def set_node(self, node, **changes):
        self._replace(node, lambda db: dataclasses.replace(db, **changes))

    def adj(self, a, b):
        return next(x for x in self.dbs["port"][a].adjacencies
                    if x.other_node_name == b)


def random_events(pair, rng, links, n_events):
    warm = 0
    for _ in range(n_events):
        a, b, _ = links[rng.randrange(len(links))]
        kind = rng.choice(("metric", "flap", "metric"))
        if kind == "metric":
            pair.set_adj(a, b, metric=rng.randint(1, 9))
        else:
            pair.set_adj(a, b, is_overloaded=not pair.adj(a, b).is_overloaded)
        assert pair.ensure()
        warm = max(warm, pair.state["port"].warm_closes)
    return warm


@pytest.mark.parametrize("name,mk", TOPOLOGIES, ids=[x[0] for x in TOPOLOGIES])
def test_state_event_sequences_match_jax(name, mk):
    edges = mk()
    pair = StatePair(edges)
    assert pair.ensure()
    assert random_events(pair, random.Random(len(name)), edges, 12) > 0
    # a node overload toggle closes cold, both ways
    node = sorted(pair.dbs["port"])[1]
    cold = pair.state["port"].cold_closes
    pair.set_node(node, is_overloaded=True)
    pair.ensure()
    pair.set_node(node, is_overloaded=False)
    pair.ensure()
    assert pair.state["port"].cold_closes == cold + 2


def test_state_on_a_500_node_wan_matches_jax():
    """n_pad 512, nb = 4: multi-block warm re-closes, then a bulk event past
    the 64 patch slots that closes cold."""
    edges = wan_edges(500, degree=4, seed=13)
    pair = StatePair(edges)
    assert pair.ensure()
    assert pair.state["port"]._nb == 4
    random_events(pair, random.Random(3), edges, 5)
    assert pair.state["port"].warm_closes > 0
    assert pair.state["port"].reclose_rounds_last is not None
    rng = random.Random(4)
    for a, b, _ in edges[:70]:
        pair.set_adj(a, b, metric=pair.adj(a, b).metric + rng.randint(5, 40))
    inv = pair.state["port"].invalidations
    cold = pair.state["port"].cold_closes
    pair.ensure()
    assert pair.state["port"].invalidations == inv + 1
    assert pair.state["port"].cold_closes == cold + 1
    assert pair.state["port"].stale_reason is None


def test_state_graph_too_large():
    pair = StatePair(grid_edges(3), max_nodes=4)
    assert not pair.ensure()
    assert not pair.state["port"].resident()
    # a resident matrix is dropped when the graph outgrows the cap
    pair = StatePair(grid_edges(3))
    assert pair.ensure()
    for s in pair.state.values():
        s.max_nodes = 4
    assert not pair.ensure()
    assert pair.state["port"].invalidations == 1
    assert pair.state["port"].stale_reason == "graph_too_large"


def _port_state(edges, **kw):
    ls = TLinkState("0")
    dbs = t_build_adj_dbs(edges)
    for db in dbs.values():
        ls.update_adjacency_database(db)
    return ls, dbs, compile_graph(ls), ApspState(4096, device="cpu", **kw)


def _failing_close(*_args, **_kwargs):
    raise RuntimeError("injected close failure")


def test_failing_close_raises_without_a_hook(monkeypatch):
    ls, _, graph, apsp = _port_state(grid_edges(3))
    monkeypatch.setattr("openr_tpu_torch.apsp.state.fw_close", _failing_close)
    with pytest.raises(RuntimeError, match="injected close failure"):
        apsp.ensure(graph)
    assert not apsp.resident() and apsp.fallback_closes == 0


def test_failing_warm_close_raises(monkeypatch):
    """A failed warm re-close raises too (no host path serves it), and the
    next ensure retries the same event on the card's matrix."""
    ls, dbs, graph, apsp = _port_state(grid_edges(3))
    assert apsp.ensure(graph)
    db = dbs["g1_1"]
    dbs["g1_1"] = dataclasses.replace(db, adjacencies=[
        dataclasses.replace(a, metric=a.metric + 5) for a in db.adjacencies
    ])
    ls.update_adjacency_database(dbs["g1_1"])
    graph = refresh_graph(graph, ls)
    monkeypatch.setattr("openr_tpu_torch.apsp.state.fw_seed", _failing_close)
    with pytest.raises(RuntimeError, match="injected close failure"):
        apsp.ensure(graph)
    assert apsp.fallback_closes == 0 and apsp.warm_closes == 0
    monkeypatch.undo()
    assert apsp.ensure(graph)
    assert apsp.warm_closes == 1 and apsp.backend == "device"
    want = tk.np_floyd_warshall(tk.build_weight_matrix(graph),
                                graph.overloaded)
    np.testing.assert_array_equal(apsp.d, want)


def test_audit_heals_a_corrupted_matrix():
    ls, dbs, graph, apsp = _port_state(grid_edges(3), audit_interval=1)
    apsp.ensure(graph)
    assert apsp.audit_runs == 1 and apsp.audit_mismatches == 0
    # corrupt the resident matrix behind the state's back, then a real
    # weight event: the warm re-close seeds from the corrupted matrix and
    # the audit must catch it and close cold in the same ensure
    apsp._d_dev = torch.as_tensor(apsp.d + 1)
    apsp._d_host = None
    db = dbs["g2_2"]
    dbs["g2_2"] = dataclasses.replace(db, adjacencies=[
        dataclasses.replace(a, metric=7) if a.other_node_name == "g2_1" else a
        for a in db.adjacencies
    ])
    ls.update_adjacency_database(dbs["g2_2"])
    graph = refresh_graph(graph, ls)
    apsp.ensure(graph)
    assert apsp.audit_mismatches == 1 and apsp.stale_reason is None
    want = tk.np_floyd_warshall(tk.build_weight_matrix(graph),
                                graph.overloaded)
    np.testing.assert_array_equal(apsp.d, want)


def test_mirror_is_an_owned_copy():
    _, _, graph, apsp = _port_state(grid_edges(3))
    apsp.ensure(graph)
    d = apsp.d
    assert not np.shares_memory(d, apsp._d_dev.numpy())
    assert apsp.d2h_bytes == d.nbytes
    apsp.row(0)
    assert apsp.d2h_bytes == d.nbytes  # one fetch per close
