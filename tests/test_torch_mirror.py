"""The port's NodeMirror / MirrorCache against nomad_tpu's.

Both packages' stores receive the same node-table writes (nomad_tpu
structs, carried across with ``convert.structs_from_reference``); the
port's mirror on CPU tensors must hold exactly the arrays, masks and
clean-usage tensors of nomad_tpu's mirror — before and after delta rolls
through the store's change log — and a rolled port mirror must equal a
fresh port build. All values are integers or exact float32 copies of
integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from nomad_tpu.api.codec import to_dict
from nomad_tpu.scheduler.util import ready_nodes_in_dcs as jax_ready_nodes
from nomad_tpu.state import StateStore as JaxStore
from nomad_tpu.tpu.mirror import MirrorCache as JaxMirrorCache
from nomad_tpu_torch.convert import solve_inputs_from_numpy, structs_from_reference
from nomad_tpu_torch.scheduler.util import ready_nodes_in_dcs
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.tpu.mirror import MirrorCache, NodeMirror

from test_fuzz_differential import (
    _MIRROR_FUZZ_CONSTRAINTS,
    _mirror_mutate,
    _mirror_rand_node,
)

torch.set_num_threads(2)

DCS = ["dc1", "dc2"]


def port_constraints():
    return [structs_from_reference(to_dict(c), "Constraint")
            for c in _MIRROR_FUZZ_CONSTRAINTS]


class DualStore:
    """Applies every node-table write to a nomad_tpu store and, with the
    node carried across, to a port store at the same index."""

    def __init__(self):
        self.jax = JaxStore()
        self.port = StateStore()

    def upsert_node(self, idx, node):
        self.jax.upsert_node(idx, node)
        self.port.upsert_node(idx, structs_from_reference(to_dict(node),
                                                          "Node"))

    def update_node_drain(self, idx, nid, drain):
        self.jax.update_node_drain(idx, nid, drain)
        self.port.update_node_drain(idx, nid, drain)

    def update_node_status(self, idx, nid, status):
        self.jax.update_node_status(idx, nid, status)
        self.port.update_node_status(idx, nid, status)

    def delete_node(self, idx, nid):
        self.jax.delete_node(idx, nid)
        self.port.delete_node(idx, nid)

    def nodes(self):
        return self.jax.nodes()

    def node_by_id(self, nid):
        return self.jax.node_by_id(nid)


def assert_mirrors_equal(port, ref, where):
    """A port mirror against a nomad_tpu mirror (or another port mirror)."""
    assert port.n == ref.n and port.padded == ref.padded, where
    assert [n.id for n in port.nodes] == [n.id for n in ref.nodes], where
    for attr in ("total", "sched_cap", "bw_avail"):
        got = getattr(port, attr)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, attr)),
                                      err_msg=f"{where}: {attr}")
    for attr in ("reserved_np", "bw_reserved", "base_mask", "totals_np"):
        np.testing.assert_array_equal(getattr(port, attr),
                                      getattr(ref, attr),
                                      err_msg=f"{where}: {attr}")
    np.testing.assert_array_equal(port.id_array(), ref.id_array())
    np.testing.assert_array_equal(port.driver_mask({"exec"}),
                                  ref.driver_mask({"exec"}))
    ref_cs = (_MIRROR_FUZZ_CONSTRAINTS if not isinstance(ref, NodeMirror)
              else port_constraints())
    for pc, rc in zip(port_constraints(), ref_cs):
        np.testing.assert_array_equal(
            port.constraint_mask(None, [pc]), ref.constraint_mask(None, [rc]),
            err_msg=f"{where}: constraint {pc.l_target} {pc.operand}")
    got, got_n = port.device_mask(None, {"exec"}, None, port_constraints()[:2])
    want, want_n = ref.device_mask(None, {"exec"}, None, ref_cs[:2])
    assert got_n == want_n, where
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(port.clean_usage(), ref.clean_usage()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(6))
def test_mirror_matches_jax_through_delta_rolls(seed):
    rng = np.random.default_rng(40_000 + seed)
    store = DualStore()
    idx = 0
    next_id = 0
    for _ in range(int(rng.integers(6, 70))):
        idx += 1
        store.upsert_node(idx, _mirror_rand_node(rng, next_id))
        next_id += 1
    port_cache, jax_cache = MirrorCache(), JaxMirrorCache()
    _n, p0 = port_cache.get(store.port.snapshot(), DCS, "cpu")
    _n, j0 = jax_cache.get(store.jax.snapshot(), DCS)
    assert_mirrors_equal(p0, j0, (seed, "build"))
    for step in range(int(rng.integers(3, 9))):
        for _ in range(int(rng.integers(1, 5))):
            idx, next_id = _mirror_mutate(rng, store, idx, next_id)
        psnap = store.port.snapshot()
        _n, rolled = port_cache.get(psnap, DCS, "cpu")
        _n, ref = jax_cache.get(store.jax.snapshot(), DCS)
        assert_mirrors_equal(rolled, ref, (seed, step, "vs nomad_tpu"))
        fresh = NodeMirror(ready_nodes_in_dcs(psnap, DCS), "cpu")
        assert_mirrors_equal(rolled, fresh, (seed, step, "vs fresh"))
    stats = port_cache.stats()
    assert stats["misses"] == stats["delta_rolls"] + stats["full_rebuilds"]


def test_mirror_cache_keys_on_device():
    store = DualStore()
    rng = np.random.default_rng(3)
    for i in range(10):
        store.upsert_node(i + 1, _mirror_rand_node(rng, i))
    cache = MirrorCache()
    snap = store.port.snapshot()
    _n, a = cache.get(snap, DCS, "cpu")
    _n, b = cache.get(snap, DCS, torch.device("cpu"))
    assert a is b and cache.stats()["hits"] == 1
    assert a.total.device.type == "cpu"


def test_solve_inputs_from_numpy_matches_mirror():
    """A nomad_tpu mirror's arrays, read with np.asarray and carried across,
    equal the port mirror's tensors for the same nodes."""
    store = DualStore()
    rng = np.random.default_rng(5)
    for i in range(40):
        store.upsert_node(i + 1, _mirror_rand_node(rng, i))
    ref = JaxMirrorCache().get(store.jax.snapshot(), DCS)[1]
    port = NodeMirror(ready_nodes_in_dcs(store.port.snapshot(), DCS), "cpu")
    mask, _n = ref.device_mask(None, {"exec"}, None, None)
    got = solve_inputs_from_numpy(dict(
        total=np.asarray(ref.total), sched_cap=np.asarray(ref.sched_cap),
        bw_avail=np.asarray(ref.bw_avail), mask=np.asarray(mask),
    ), device="cpu")
    assert got["mask"].dtype == torch.bool
    assert torch.equal(got["total"], port.total)
    assert torch.equal(got["sched_cap"], port.sched_cap)
    assert torch.equal(got["bw_avail"], port.bw_avail)
    assert torch.equal(got["mask"],
                       port.device_mask(None, {"exec"}, None, None)[0])
    assert len(jax_ready_nodes(store.jax.snapshot(), DCS)) == port.n
    with pytest.raises(KeyError):
        solve_inputs_from_numpy({"nope": np.zeros(3)}, device="cpu")


def test_structs_from_reference_round_trip():
    rng = np.random.default_rng(9)
    node = _mirror_rand_node(rng, 1)
    port = structs_from_reference(to_dict(node), "Node")
    assert to_dict(port) == to_dict(node)
    assert type(port).__module__ == "nomad_tpu_torch.structs"
