"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

* The port's MessagePack codec gives the bytes ``msgpack.packb(x,
  use_bin_type=True)`` gives and decodes to what ``msgpack.unpackb(x,
  raw=False)`` decodes (a fixed table: ints at every width boundary of
  either sign, floats, str and bin at every length boundary, nested maps
  and arrays, None), and refuses other types with a ``TypeError``.
* Its leaf paths and their order equal JAX's ``tree_flatten_with_path``
  strings on nested dicts, lists and tuples.
* A tree saved by either package loads in the other bitwise; an
  uncommitted checkpoint is invisible; the manager's retention, latest
  step and async save (not changed by an in-place edit made after
  ``save`` returns) work; a structure mismatch raises (as
  ``tests/test_checkpoint.py`` pins for the reference).

Exact comparisons throughout (bytes, dtypes, shapes, array bits).  The
index checkpoints, which need built indexes, are in
``tests/test_torch_serving.py``.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro_torch import checkpoint as port_ckpt
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import manager as port_manager
from _torch_threads import one_torch_thread  # noqa: F401

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**63 - 1, 2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
        -32769, -2**31, -2**31 - 1, -2**63]
FLOATS = [0.0, -0.0, 1.5, -2.25, 1e-300, 1e300, float("inf"),
          float("-inf"), 3.141592653589793, np.float64(0.1)]
STRS = ["", "a", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65535,
        "x" * 65536, "é—≤", "['payload']/['eapca_box']"]
BINS = [b"", b"\x00", b"b" * 255, b"b" * 256, b"b" * 65535, b"b" * 65536,
        bytearray(b"ab")]
CONTAINERS = [
    None, True, False, [], (), {}, list(range(15)), list(range(16)),
    list(range(65535)), list(range(65536)),
    {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {f"k{i}": i for i in range(65536)},
    {"manifest": [{"path": "['a']", "key": "a0", "dtype": "float32",
                   "shape": [3, 4]}],
     "metadata": {"z": None, "a": [1, -1.5, "s", b"b", [{"x": (1, 2)}]],
                  "nested": {"deep": {"deeper": [True, False, {}]}}}},
    {b"bin-key": 1, "str-key": 2},
]
TABLE = INTS + FLOATS + STRS + BINS + CONTAINERS


def _label(v):
    r = repr(v)
    return r if len(r) <= 40 else f"{type(v).__name__}[{len(v)}]"


@pytest.mark.parametrize("value", TABLE, ids=_label)
def test_codec_bytes_equal_msgpack(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_round_trips_every_table_value():
    blob = msgpack.packb(TABLE, use_bin_type=True)
    assert _msgpack.packb(TABLE) == blob
    got = _msgpack.unpackb(blob)
    assert got == msgpack.unpackb(blob, raw=False)
    assert [type(v) for v in got] == [type(v) for v in
                                      msgpack.unpackb(blob, raw=False)]


@pytest.mark.parametrize("value", [np.int64(3), np.float32(1.0),
                                   np.zeros(2), {1, 2}, object(), 1j,
                                   torch.zeros(1)],
                         ids=lambda v: type(v).__name__)
def test_codec_refuses_other_types(value):
    with pytest.raises(TypeError):
        _msgpack.packb(value)
    with pytest.raises(TypeError):
        msgpack.packb(value, use_bin_type=True)


@pytest.mark.parametrize("value", [2**64, -2**63 - 1])
def test_codec_refuses_ints_beyond_64_bits(value):
    with pytest.raises(OverflowError):
        _msgpack.packb(value)
    with pytest.raises(OverflowError):
        msgpack.packb(value, use_bin_type=True)


@pytest.mark.parametrize("blob", [b"\xcb\x00", b"\x92\x01", b"\x01\x02",
                                  b"\xc1", b"\x81\x01\x02"],
                         ids=["truncated-float", "truncated-array",
                              "extra-data", "never-used", "int-map-key"])
def test_codec_refuses_malformed_blobs(blob):
    with pytest.raises(ValueError):
        _msgpack.unpackb(blob)
    with pytest.raises(ValueError):
        msgpack.unpackb(blob, raw=False)


def test_codec_refuses_extension_types():
    """msgpack decodes an extension type to its ``ExtType``; checkpoint
    metadata holds none, so the port's codec refuses it."""
    assert isinstance(msgpack.unpackb(b"\xd4\x01\x02", raw=False),
                      msgpack.ExtType)
    with pytest.raises(ValueError, match="type byte 0xd4"):
        _msgpack.unpackb(b"\xd4\x01\x02")


def test_codec_on_an_index_checkpoints_metadata(tmp_path):
    """The metadata ``save_index`` writes (a tree-only index, no filters:
    kind, sizes, the config with its None and its int above 2**32, the
    build report): the port's ``tree.msgpack`` bytes equal msgpack's
    encoding of msgpack's own decoding of them."""
    from repro_torch import bridge
    from repro_torch.core import tree
    from repro_torch.serving import save_index
    S = np.random.default_rng(0).standard_normal((300, 16)).astype(
        np.float32).cumsum(1)
    idx = tree.build_dstree(S, leaf_capacity=32)
    lfi = bridge.leafi_from_arrays(
        index={"kind": idx.kind, "series": idx.series.numpy(),
               "order": idx.order.numpy(),
               "leaf_start": idx.leaf_start.numpy(),
               "leaf_size": idx.leaf_size.numpy(),
               "max_leaf_size": idx.max_leaf_size,
               "n_series": idx.n_series, "length": idx.length,
               "payload": {k: v.numpy() for k, v in idx.payload.items()}},
        filter_params=None, leaf_ids=np.zeros(0, np.int64), tuner=None,
        device="cpu")
    lfi.build_report.update(t_index_build=0.125, n_leaves=float(
        idx.n_leaves))
    save_index(str(tmp_path / "idx"), lfi, {"note": "hi", "n": -7})
    blob = (tmp_path / "idx" / "tree.msgpack").read_bytes()
    decoded = msgpack.unpackb(blob, raw=False)
    assert _msgpack.unpackb(blob) == decoded
    assert msgpack.packb(decoded, use_bin_type=True) == blob
    meta = decoded["metadata"]
    assert meta["config"]["hidden"] is None
    assert meta["config"]["filter_memory_budget_bytes"] == 6 << 30
    assert meta["note"] == "hi" and meta["n"] == -7


# ---------------------------------------------------------------------------
# leaf paths
# ---------------------------------------------------------------------------

TREES = {
    "flat": {"b": np.zeros(2), "a": np.ones(3)},
    "nested": {"payload": {"eapca_box": np.zeros((2, 3)),
                           "seg_len": np.arange(3)},
               "series": np.zeros((4, 2)), "tuner": {}, "calib": {}},
    "lists": {"lst": [np.zeros(1), [np.ones(1), (np.zeros(2), None)]],
              "t": (np.arange(2),)},
    "root-list": [np.zeros(1), {"z": np.ones(1), "y": [np.zeros(1)]}],
    "root-leaf": np.arange(4),
    "empty": {"a": [], "b": (), "c": {}, "d": None},
}


@pytest.mark.parametrize("name", list(TREES))
def test_leaf_paths_equal_jax_key_paths(name):
    tree = TREES[name]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want_paths = ["/".join(str(k) for k in path) for path, _ in flat]
    paths, leaves = port_manager.flatten_with_paths(tree)
    assert paths == want_paths
    for got, (_, want) in zip(leaves, flat):
        assert got is want
    # map_leaves sees the same paths and keeps the structure
    back = port_manager.map_leaves(lambda p, x: p, tree)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    assert jax.tree_util.tree_leaves(back) == want_paths


# ---------------------------------------------------------------------------
# checkpoint layout, both ways
# ---------------------------------------------------------------------------


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((17, 5)).astype(np.float32),
                       "b": np.zeros(5, np.float32)},
            "opt": {"m": np.ones((17, 5), np.float32),
                    "step": np.asarray(7, np.int32),
                    "hist": [np.arange(4, dtype=np.int64),
                             (np.full(2, -1, np.int8),
                              np.asarray([1.5], np.float64))]}}


def _torch_tree(seed):
    return port_manager.map_leaves(
        lambda _, x: torch.from_numpy(np.array(x)), _np_tree(seed))


def _assert_same(got_leaves, want_leaves):
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["tensors", "numpy"])
def test_port_save_loads_in_the_reference(tmp_path, kind):
    tree = _torch_tree(0) if kind == "tensors" else _np_tree(0)
    p = str(tmp_path / "ck")
    port_ckpt.save_pytree(p, tree, {"note": "hi", "step": 3})
    restored, meta = ref_ckpt.load_pytree(p, like=_np_tree(1))
    assert meta == {"note": "hi", "step": 3}
    _assert_same(jax.tree.leaves(restored), jax.tree.leaves(_np_tree(0)))
    flat, _ = ref_ckpt.load_pytree(p)
    assert list(flat) == port_manager.flatten_with_paths(tree)[0]


def test_reference_save_loads_in_the_port(tmp_path):
    p = str(tmp_path / "ck")
    ref_ckpt.save_pytree(p, jax.tree.map(jnp.asarray, _np_tree(0)),
                         {"note": "hi"})
    restored, meta = port_ckpt.load_pytree(p, like=_torch_tree(1))
    assert meta == {"note": "hi"}
    leaves = port_manager.flatten_with_paths(restored)[1]
    assert all(isinstance(x, torch.Tensor) for x in leaves)
    # restored in like's dtypes: the reference (no x64) wrote int64 and
    # float64 leaves as int32 and float32
    want = [np.asarray(x) for x in jax.tree.leaves(_np_tree(0))]
    for got, w in zip(leaves, want):
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)
    restored, _ = port_ckpt.load_pytree(p, like=_np_tree(1))
    _assert_same(port_manager.flatten_with_paths(restored)[1],
                 jax.tree.leaves(_np_tree(0)))


def test_both_packages_write_the_same_files(tmp_path):
    """Saved from numpy leaves, the two checkpoints' ``tree.msgpack`` bytes
    and arrays are the same."""
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    port_ckpt.save_pytree(a, _np_tree(0), {"note": "hi", "x": [1, 2.5]})
    ref_ckpt.save_pytree(b, _np_tree(0), {"note": "hi", "x": [1, 2.5]})
    for name in ("tree.msgpack", "DONE"):
        assert open(os.path.join(a, name), "rb").read() == \
            open(os.path.join(b, name), "rb").read()
    with np.load(os.path.join(a, "arrays.npz")) as za, \
            np.load(os.path.join(b, "arrays.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        _assert_same([za[k] for k in sorted(za.files)],
                     [zb[k] for k in sorted(zb.files)])
    assert not os.path.exists(a + ".tmp")


def test_uncommitted_checkpoint_is_invisible(tmp_path):
    p = str(tmp_path / "ck")
    port_ckpt.save_pytree(p, _torch_tree(0))
    os.remove(os.path.join(p, "DONE"))        # a torn write
    with pytest.raises(FileNotFoundError):
        port_ckpt.load_pytree(p, like=_torch_tree(0))
    with pytest.raises(FileNotFoundError):
        ref_ckpt.load_pytree(p, like=_np_tree(0))
    mgr = port_ckpt.CheckpointManager(str(tmp_path / "mgr"),
                                      async_save=False)
    mgr.save(1, _torch_tree(1))
    os.remove(os.path.join(mgr._step_dir(1), "DONE"))
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(like=_torch_tree(0))


def test_manager_retention_and_latest(tmp_path):
    mgr = port_ckpt.CheckpointManager(str(tmp_path), keep=2,
                                      async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, _torch_tree(s))
    assert mgr.all_steps() == [20, 30]
    assert mgr.latest_step() == 30
    restored, meta = mgr.restore(like=_torch_tree(0))
    assert meta["step"] == 30
    _assert_same(port_manager.flatten_with_paths(restored)[1],
                 port_manager.flatten_with_paths(_torch_tree(30))[1])
    # the reference's manager reads the port's steps
    ref_mgr = ref_ckpt.CheckpointManager(str(tmp_path), async_save=False)
    assert ref_mgr.all_steps() == [20, 30]
    restored, meta = ref_mgr.restore(like=_np_tree(0), step=20)
    assert meta["step"] == 20
    _assert_same(jax.tree.leaves(restored), jax.tree.leaves(_np_tree(20)))


def test_manager_async_save_ignores_later_in_place_edits(tmp_path):
    mgr = port_ckpt.CheckpointManager(str(tmp_path), keep=3,
                                      async_save=True)
    tree = _torch_tree(1)
    want = port_manager.flatten_with_paths(_torch_tree(1))[1]
    mgr.save(1, tree)
    # the caller reuses its buffers as soon as save returns
    for leaf in port_manager.flatten_with_paths(tree)[1]:
        leaf.fill_(42)
    np_tree = _np_tree(2)
    mgr.save(2, np_tree)
    np_tree["params"]["w"][:] = -1.0
    mgr.wait()
    assert mgr.latest_step() == 2
    restored, _ = mgr.restore(like=_torch_tree(0), step=1)
    _assert_same(port_manager.flatten_with_paths(restored)[1], want)
    restored, _ = mgr.restore(like=_np_tree(0), step=2)
    _assert_same(port_manager.flatten_with_paths(restored)[1],
                 port_manager.flatten_with_paths(_np_tree(2))[1])


def test_restore_structure_mismatch_raises(tmp_path):
    mgr = port_ckpt.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, _torch_tree(0))
    subset = {"params": {"w": torch.zeros((17, 5))}}
    restored, _ = mgr.restore(like=subset)             # a subset restores
    assert restored["params"]["w"].shape == (17, 5)
    with pytest.raises(KeyError):
        mgr.restore(like={"nope": torch.zeros(3)})
    with pytest.raises(KeyError):
        mgr.restore(like={"params": [torch.zeros(3)]})


def test_restore_keeps_like_dtypes_and_devices(tmp_path):
    p = str(tmp_path / "ck")
    port_ckpt.save_pytree(p, {"a": torch.arange(5, dtype=torch.int64),
                              "b": np.linspace(0, 1, 4)})
    like = {"a": torch.zeros(5, dtype=torch.int32),
            "b": torch.zeros(4, dtype=torch.float32)}
    restored, _ = port_ckpt.load_pytree(p, like=like)
    assert restored["a"].dtype == torch.int32
    assert restored["a"].tolist() == [0, 1, 2, 3, 4]
    assert restored["b"].dtype == torch.float32
    assert restored["b"].device.type == "cpu"
    np.testing.assert_array_equal(restored["b"].numpy(),
                                  np.linspace(0, 1, 4).astype(np.float32))
