"""DeviceNphdIndex with a mesh: engine-level sharded serving on the
virtual 8-device mesh."""

import numpy as np
import pytest

from iscc_search_tpu.engine import DeviceNphdIndex
from iscc_search_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_sharded_engine_matches_single_device(tmp_path, mesh):
    rng = np.random.default_rng(81)
    bodies = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(500)]
    keys = list(range(500))

    single = DeviceNphdIndex(tmp_path / "single")
    single.add(keys, bodies)
    sharded = DeviceNphdIndex(tmp_path / "sharded", mesh=mesh)
    sharded.add(keys, bodies)
    assert sharded.mesh is not None

    queries = [bodies[3], bodies[44], bodies[3][:8]]
    res_single = single.search(queries, 7)
    res_sharded = sharded.search(queries, 7)
    for (k1, s1), (k2, s2) in zip(res_single, res_sharded):
        assert np.allclose(np.sort(s1)[::-1], np.sort(s2)[::-1], atol=2e-3)
        assert k1[0].tobytes() == k2[0].tobytes()  # same top hit
    single.close()
    sharded.close()


def test_sharded_engine_update_remove(tmp_path, mesh):
    rng = np.random.default_rng(82)
    idx = DeviceNphdIndex(tmp_path / "i", mesh=mesh)
    b1, b2 = (rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(2))
    idx.add([1, 2], [b1, b2])
    idx.remove([2])
    res = idx.search_one(b2, 5)
    assert 2 not in res
    idx.add([1], [b2])  # update key 1
    res = idx.search_one(b2, 5)
    assert res[1] == pytest.approx(1.0, abs=1e-3)
    idx.close()


def test_mesh_of_one_disables_sharding(tmp_path):
    mesh1 = make_mesh(1)
    idx = DeviceNphdIndex(tmp_path / "i", mesh=mesh1)
    assert idx.mesh is None  # falls back to the single-device path
    idx.close()


def test_tpu_index_with_mesh_option(tmp_path, entry_factory):
    """End-to-end TpuIndex on an 8-device mesh via the mesh_devices option."""
    from iscc_search_tpu.indexes.tpu import TpuIndex
    from iscc_search_tpu.schema import IsccEntry, IsccQuery

    idx = TpuIndex(tmp_path / "m", mesh_devices=8, search_batching=False)
    entries = [IsccEntry(**entry_factory()) for _ in range(20)]
    idx.add_assets(entries)
    assert idx._nphd_indexes["DATA_NONE_V0"].mesh is not None
    res = idx.search_assets(IsccQuery(units=entries[7].units), limit=5)
    assert res.global_matches[0].iscc_id == entries[7].iscc_id
    assert res.global_matches[0].score == pytest.approx(1.0, abs=1e-3)
    idx.close()


def test_sharded_engine_tombstones_respected_on_pallas_path(tmp_path, mesh):
    rng = np.random.default_rng(84)
    bodies = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(300)]
    idx = DeviceNphdIndex(tmp_path / "t", mesh=mesh)
    idx.add(list(range(300)), bodies)
    idx.remove([7])
    (keys, scores), = idx.search([bodies[7]], 3)
    assert 7 not in [int.from_bytes(k.tobytes(), "big") for k in keys]
    idx.close()


class Test2DMesh:
    """DeviceNphdIndex over the 2-D (dcn x ici) multi-host-shaped mesh: the
    engine routes through the hierarchical ICI->DCN merge (parallel/merge)
    while keeping full result parity with the single-device path."""

    @pytest.fixture(scope="class")
    def mesh2d(self):
        from iscc_search_tpu.parallel import make_mesh_2d

        return make_mesh_2d(2, 4)

    def test_matches_single_device_mixed_lengths(self, tmp_path, mesh2d):
        rng = np.random.default_rng(91)
        bodies = [
            rng.integers(0, 256, int(rng.choice([8, 16, 32])), dtype=np.uint8).tobytes()
            for _ in range(3000)
        ]
        keys = list(range(3000))
        single = DeviceNphdIndex(tmp_path / "single")
        single.add(keys, bodies)
        sharded = DeviceNphdIndex(tmp_path / "sharded", mesh=mesh2d)
        sharded.add(keys, bodies)
        # tombstones must mask identically on both paths
        dead = list(range(0, 3000, 17))
        single.remove(dead)
        sharded.remove(dead)

        queries = [bodies[3], bodies[44], bodies[3][:8], bodies[100]]
        for (k1, s1), (k2, s2) in zip(single.search(queries, 9), sharded.search(queries, 9)):
            assert np.allclose(np.sort(s1)[::-1], np.sort(s2)[::-1], atol=2e-3)
            assert k1[0].tobytes() == k2[0].tobytes()
        single.close()
        sharded.close()

    def test_update_and_large_count(self, tmp_path, mesh2d):
        rng = np.random.default_rng(92)
        idx = DeviceNphdIndex(tmp_path / "i", mesh=mesh2d)
        bodies = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(600)]
        idx.add(list(range(600)), bodies)
        idx.add([0], [bodies[1]])  # update key 0 to body 1
        res = idx.search_one(bodies[1], 5)
        assert res[0] == pytest.approx(1.0, abs=2e-3)
        # count > per-shard k exercises the widened hierarchical merge
        (keys, scores), = idx.search([bodies[2]], 300)
        assert len(scores) == 300
        assert scores[0] == pytest.approx(1.0, abs=2e-3)
        idx.close()
