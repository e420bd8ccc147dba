"""The port's handle stores (gatling_tpu_torch/utils/handles.py) on the
cases of tests/test_utils.py, and the GiScene mesh store they back: stable
object ids across removals, stale handles detected."""

import numpy as np
import pytest

from gatling_tpu_torch.utils.handles import HandleStore, LinearDataStore


def test_handle_allocate_free_reuse():
    hs = HandleStore()
    h1 = hs.allocate()
    h2 = hs.allocate()
    assert h1 != h2
    assert hs.is_valid(h1) and hs.is_valid(h2)
    hs.free(h1)
    assert not hs.is_valid(h1)
    h3 = hs.allocate()  # reuses the slot of h1 with a bumped version
    assert hs.is_valid(h3)
    assert h3 != h1
    assert (h3 & 0xFFFFFFFF) == (h1 & 0xFFFFFFFF)
    assert not hs.is_valid(h1)  # a stale handle stays invalid


def test_handle_double_free_raises():
    hs = HandleStore()
    h = hs.allocate()
    hs.free(h)
    with pytest.raises(KeyError):
        hs.free(h)


def test_linear_data_store():
    store = LinearDataStore()
    a = store.allocate({"x": 1})
    b = store.allocate({"x": 2})
    assert store.get(a)["x"] == 1
    assert store.get(b)["x"] == 2
    store.free(a)
    with pytest.raises(KeyError):
        store.get(a)
    assert len(store) == 1
    assert [v["x"] for v in store.values()] == [2]


def test_handles_match_jax_package():
    """The same allocate/free sequence gives the same handles in both
    packages."""
    from gatling_tpu.utils.handles import HandleStore as JaxHandleStore

    ours, theirs = HandleStore(), JaxHandleStore()
    rng = np.random.default_rng(7)
    live_o, live_t = [], []
    for _ in range(200):
        if live_o and rng.random() < 0.4:
            k = int(rng.integers(len(live_o)))
            ours.free(live_o.pop(k))
            theirs.free(live_t.pop(k))
        else:
            live_o.append(ours.allocate())
            live_t.append(theirs.allocate())
        assert live_o == live_t


def _tri_mesh():
    from gatling_tpu_torch.scene.meshproc import build_triangulated_mesh

    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    return build_triangulated_mesh(pts, np.array([3]), np.array([0, 1, 2]))


def test_gi_scene_mesh_handles():
    """GiScene's mesh registration rides the handle store: survivors keep
    their object ids across removals, the freed slot is reused, and a
    stale handle raises (tests/test_utils.py test_gi_scene_mesh_handles)."""
    from gatling_tpu_torch.gi import create_scene
    from gatling_tpu_torch.scene.stage import MeshDesc

    tri = _tri_mesh()

    def mk():
        return MeshDesc(path="/m", mesh=tri, transform=np.eye(4), material=None,
                        double_sided=False, object_id=-1)

    scene = create_scene("cpu")
    a, b, c = scene.add_mesh(mk()), scene.add_mesh(mk()), scene.add_mesh(mk())
    assert (a.object_id, b.object_id, c.object_id) == (0, 1, 2)
    scene.remove_mesh(b)
    assert (a.object_id, c.object_id) == (0, 2)
    d = scene.add_mesh(mk())
    assert d.object_id == 1
    with pytest.raises(KeyError):
        scene.remove_mesh(b)  # stale handle
    assert scene.meshes == [a, c, d]
