"""The port's checkpoints (``horovod_tpu_torch.utils.checkpoint``) and
``elastic.State`` held against the JAX package's.

Mirrors ``tests/test_checkpoint.py`` (round trip; a missing or torn path
naming the nearest complete checkpoint; ``latest_checkpoint``,
``restore_latest``, ``restart_epoch``), the atomic-write cases of
``tests/test_elastic.py`` (the torn-save matrix of the plain writer, the
``.prev`` recovery, the orphan sweep), ``tests/test_sharded_checkpoint.py``
(layout and digest, the sharded torn-save matrix, the corrupt-shard
fallback, the async writer's persist, prune, latest-wins and failure
paths, ``State.commit`` feeding the writer) and ``State``'s semantics.
The sharded format is shared: files written by either package restore
in the other with equal bytes and digests. One 2-rank gloo job holds
``restore_checkpoint``'s broadcast and ``State.restore`` over it.
"""

import copy
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.elastic as jelastic
from horovod_tpu.utils import checkpoint as jckpt
import horovod_tpu_torch as thvd
import horovod_tpu_torch.elastic as telastic
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.utils import checkpoint as tckpt

from torch_gloo import REPO, WORKER_HEAD, run_job


@pytest.fixture
def port_state():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _fake_save(tag):
    def write(path):
        os.makedirs(path)
        with open(os.path.join(path, "data"), "w") as f:
            f.write(tag)
    return write


# ---------------------------------------------------------------------------
# The plain checkpoint


def test_save_restore_roundtrip(tmp_path, port_state):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": {"mu": torch.ones(4), "step": 7},
            "stats": [torch.zeros(2, dtype=torch.int64), 1.5]}
    path = str(tmp_path / "ckpt_100")
    tckpt.save_checkpoint(path, tree)
    restored = tckpt.restore_checkpoint(path, like=tree)
    assert torch.equal(restored["w"], tree["w"])
    assert torch.equal(restored["opt"]["mu"], tree["opt"]["mu"])
    assert restored["opt"]["step"] == 7 and restored["stats"][1] == 1.5
    assert torch.equal(restored["stats"][0], tree["stats"][0])
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(path, like={"w": tree["w"]})


def test_restore_missing_or_torn_path_is_loud(tmp_path, port_state):
    tckpt.save_checkpoint(str(tmp_path / "ckpt_7"), {"x": torch.ones(2)})
    missing = str(tmp_path / "ckpt_9")
    with pytest.raises(FileNotFoundError) as info:
        tckpt.restore_checkpoint(missing)
    msg = str(info.value)
    assert missing in msg and "ckpt_7" in msg and "missing" in msg
    torn = str(tmp_path / "ckpt_9.tmp.123")
    os.makedirs(torn)
    with pytest.raises(FileNotFoundError, match="torn"):
        tckpt.restore_checkpoint(torn)
    with pytest.raises(FileNotFoundError, match="none"):
        tckpt.restore_checkpoint(str(tmp_path / "other" / "ckpt_1"))


def test_latest_checkpoint(tmp_path, port_state):
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    for step in (10, 200, 30):
        tckpt.save_checkpoint(str(tmp_path / f"ckpt_{step}"),
                              {"x": torch.ones(1)})
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest is not None and latest.endswith("ckpt_200")
    assert latest == jckpt.latest_checkpoint(str(tmp_path))


def test_restore_latest_and_restart_epoch(tmp_path, port_state,
                                          monkeypatch):
    assert tckpt.restore_latest(str(tmp_path)) == (None, None)
    for step in (3, 40):
        tckpt.save_checkpoint(str(tmp_path / f"ckpt_{step}"),
                              {"step": step, "w": torch.ones(2) * step})
    path, tree = tckpt.restore_latest(str(tmp_path))
    assert path.endswith("ckpt_40") and tree["step"] == 40
    assert torch.equal(tree["w"], torch.full((2,), 40.0))
    for value, want in ((None, 0), ("2", 2), ("garbage", 0), ("-3", 0)):
        if value is None:
            monkeypatch.delenv("HOROVOD_RESTART_EPOCH", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_RESTART_EPOCH", value)
        assert tckpt.restart_epoch() == want == jckpt.restart_epoch()


def test_elastic_config_knobs_match_jax(monkeypatch):
    from horovod_tpu.common import config as jconfig

    for var in ("HOROVOD_ELASTIC", "HOROVOD_CKPT_DIR", "HOROVOD_CKPT_KEEP",
                "HOROVOD_ELASTIC_RESTORE"):
        monkeypatch.delenv(var, raising=False)
    knobs = ("elastic_enabled", "elastic_ckpt_dir", "elastic_ckpt_keep",
             "elastic_restore_mode", "restart_epoch")

    def both():
        return [(getattr(tconfig, k)(), getattr(jconfig, k)()) for k in knobs]

    assert all(a == b for a, b in both())
    assert tconfig.elastic_ckpt_keep() == 2
    assert tconfig.elastic_restore_mode() == "p2p"
    for env in ({"HOROVOD_ELASTIC": "1", "HOROVOD_CKPT_DIR": "  /x  ",
                 "HOROVOD_CKPT_KEEP": "garbage",
                 "HOROVOD_ELASTIC_RESTORE": "Broadcast"},
                {"HOROVOD_ELASTIC": "off", "HOROVOD_CKPT_DIR": "   ",
                 "HOROVOD_CKPT_KEEP": "1", "HOROVOD_ELASTIC_RESTORE": "junk"},
                {"HOROVOD_CKPT_KEEP": "5"}):
        for k, v in sorted(env.items()):
            monkeypatch.setenv(k, v)
        assert all(a == b for a, b in both()), both()


# ---------------------------------------------------------------------------
# The atomic writer: the torn-save matrix


def test_atomic_write_lands_whole_and_leaves_no_tmp(tmp_path):
    target = str(tmp_path / "ckpt_5")
    tckpt._write_atomically(target, _fake_save("v1"))
    assert open(os.path.join(target, "data")).read() == "v1"
    assert os.listdir(tmp_path) == ["ckpt_5"]
    tckpt._write_atomically(target, _fake_save("v2"))
    assert open(os.path.join(target, "data")).read() == "v2"
    assert os.listdir(tmp_path) == ["ckpt_5"]
    with pytest.raises(FileExistsError):
        tckpt._write_atomically(target, _fake_save("v3"), force=False)
    assert open(os.path.join(target, "data")).read() == "v2"


def test_interrupted_save_leaves_previous_checkpoint_loadable(tmp_path):
    target = str(tmp_path / "ckpt_5")
    tckpt._write_atomically(target, _fake_save("good"))

    def torn(path):
        os.makedirs(path)
        raise KeyboardInterrupt("rank killed mid-save")

    with pytest.raises(KeyboardInterrupt):
        tckpt._write_atomically(target, torn)
    assert open(os.path.join(target, "data")).read() == "good"
    assert tckpt.latest_checkpoint(str(tmp_path)) == target


def test_latest_checkpoint_skips_incomplete_entries(tmp_path):
    for name in ("ckpt_3", "ckpt_10"):
        tckpt._write_atomically(str(tmp_path / name), _fake_save(name))
    os.makedirs(tmp_path / "ckpt_99.tmp.1234")
    os.makedirs(tmp_path / "ckpt_99.tmp.1234.old")
    os.makedirs(tmp_path / "ckpt_junk")
    assert tckpt.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "ckpt_10")


def test_stale_tmp_orphans_of_other_pids_are_swept(tmp_path):
    target = str(tmp_path / "ckpt_5")
    os.makedirs(f"{target}.tmp.99999")
    tckpt._write_atomically(target, _fake_save("fresh"))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_5"]


def test_kill_between_overwrite_renames_resumes_from_prev(tmp_path,
                                                          port_state):
    _fake_save("old")(str(tmp_path / "ckpt_5.prev"))
    os.makedirs(tmp_path / "ckpt_5.tmp.1234")
    assert tckpt.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "ckpt_5.prev")
    _fake_save("whole")(str(tmp_path / "ckpt_5"))
    assert tckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_5")
    # A .prev is a whole save: it restores.
    shutil.rmtree(tmp_path / "ckpt_5")
    shutil.rmtree(tmp_path / "ckpt_5.prev")
    tckpt.save_checkpoint(str(tmp_path / "ckpt_6"), {"x": torch.ones(1)})
    os.rename(tmp_path / "ckpt_6", tmp_path / "ckpt_6.prev")
    path = tckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_6.prev")
    assert torch.equal(tckpt.restore_checkpoint(path)["x"], torch.ones(1))


# ---------------------------------------------------------------------------
# The sharded layout, digests and interchange with the JAX package


def test_shard_layout_deterministic_balanced_and_equal_to_jax():
    sizes = [100, 1, 1, 50, 50, 100]
    for world in (1, 2, 3, 5):
        layout = tckpt.shard_layout(sizes, world)
        assert layout == tckpt.shard_layout(sizes, world)
        assert layout == jckpt.shard_layout(sizes, world)
        assert sorted(i for ids in layout for i in ids) == list(range(6))
    weights = [sum(sizes[i] for i in ids)
               for ids in tckpt.shard_layout(sizes, 3)]
    assert max(weights) - min(weights) <= max(sizes)
    assert tckpt.shard_layout([], 2) == [[], []]
    with pytest.raises(ValueError):
        tckpt.shard_layout(sizes, 0)


def test_shard_digest_keys_on_dtype_shape_and_bytes():
    a = np.arange(6, dtype=np.float32)
    assert tckpt.shard_digest([a]) == tckpt.shard_digest([a.copy()])
    assert tckpt.shard_digest([a]) == jckpt.shard_digest([a])
    # A tensor digests as its numpy form.
    assert tckpt.shard_digest([torch.from_numpy(a)]) == \
        jckpt.shard_digest([a])
    assert tckpt.shard_digest([a]) != tckpt.shard_digest(
        [a.astype(np.float64)])
    assert tckpt.shard_digest([a]) != tckpt.shard_digest([a.reshape(2, 3)])
    b = a.copy()
    b[3] += 1
    assert tckpt.shard_digest([a]) != tckpt.shard_digest([b])


def test_pack_unpack_validates_digest_and_matches_jax_bytes():
    arrays = [np.arange(4.0), np.ones((2, 2), np.int32)]
    blob = tckpt.pack_shard(arrays)
    assert blob == jckpt.pack_shard(arrays)
    assert blob == tckpt.pack_shard([torch.from_numpy(a) for a in arrays])
    out = tckpt.unpack_shard(blob, expect_digest=tckpt.shard_digest(arrays))
    for x, y in zip(arrays, out):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="digest mismatch"):
        tckpt.unpack_shard(blob, expect_digest="deadbeef")


def _write_step(mod, directory, step, world, leaves, prefix="sharded_"):
    """One complete sharded step written by ``mod`` (either package)."""
    layout = mod.shard_layout([a.nbytes for a in leaves], world)
    digests = []
    for k in range(world):
        arrays = [leaves[i] for i in layout[k]]
        digests.append(mod.shard_digest(arrays))
        mod.save_shard(directory, step, k, world, arrays, prefix=prefix)
    mod.write_manifest(directory, step, {
        "step": step, "epoch": 1, "world_size": world, "layout": layout,
        "digests": digests, "objects_hex": mod.pack_objects({}),
    }, prefix=prefix)
    return layout, digests


LEAVES = [np.arange(8, dtype=np.float32), np.full((3, 3), 7, np.int64),
          np.ones(1, np.float32)]


@pytest.mark.parametrize("writer,reader", [(jckpt, tckpt), (tckpt, jckpt),
                                           (tckpt, tckpt)])
def test_sharded_interchange_between_packages(tmp_path, writer, reader):
    """A step written by either package restores through the other, with
    equal bytes on disk and equal digests."""
    d = str(tmp_path / "w")
    _, digests = _write_step(writer, d, 1, 2, LEAVES)
    step, manifest = reader.latest_sharded_checkpoint(d)
    assert step == 1 and manifest["digests"] == digests
    step, tree = reader.restore_latest_sharded(
        d, [np.zeros_like(a) for a in LEAVES])
    assert step == 1
    for x, y in zip(LEAVES, tree):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    other = str(tmp_path / "o")
    _write_step(reader, other, 1, 2, LEAVES)
    for name in sorted(os.listdir(d)):
        for f in ("shard.bin", "manifest.json"):
            p = os.path.join(d, name, f)
            if os.path.exists(p):
                assert open(p, "rb").read() == \
                    open(os.path.join(other, name, f), "rb").read(), p


def test_async_writers_of_both_packages_write_the_same_files(tmp_path):
    """The JAX package's AsyncShardWriter and the port's, fed the same
    snapshot, write byte-identical shards and manifests; each restores
    the other's."""
    arrays = [np.arange(5, dtype=np.float32), np.arange(3, dtype=np.int32)]
    manifest = {"step": 1, "epoch": 1, "world_size": 1, "layout": [[0, 1]],
                "digests": [jckpt.shard_digest(arrays)],
                "objects_hex": jckpt.pack_objects({2: 11})}
    dirs = {}
    for name, mod in (("jax", jckpt), ("port", tckpt)):
        w = mod.AsyncShardWriter(str(tmp_path / name))
        w.submit(1, 0, 1, arrays, manifest=dict(manifest))
        assert w.flush(10.0)
        w.close()
        dirs[name] = str(tmp_path / name)
    for entry in ("sharded_1.shard0of1/shard.bin",
                  "sharded_1.manifest/manifest.json"):
        a, b = (open(os.path.join(d, entry), "rb").read()
                for d in (dirs["jax"], dirs["port"]))
        assert a == b, entry
    like = {"a": np.zeros(5, np.float32), "b": np.zeros(3, np.int32),
            "c": 0}
    for reader, d in ((tckpt, dirs["jax"]), (jckpt, dirs["port"])):
        step, tree = reader.restore_latest_sharded(d, like)
        assert step == 1 and tree["c"] == 11
        np.testing.assert_array_equal(tree["a"], arrays[0])


def test_state_commits_of_both_packages_agree(tmp_path, port_state):
    """The same tracked tree committed through the JAX ``State`` and the
    port's: the same layout, digests and object leaves (JAX's leaf
    order: dict keys sorted), and each package restores the other's
    files. The port restores tensors where ``like`` holds tensors."""
    rng = np.random.RandomState(3)
    tree = {"zeta": rng.randn(7).astype(np.float32),
            "alpha": {"w": rng.randn(4, 3).astype(np.float32),
                      "b": np.arange(5, dtype=np.int64)},
            "mid": rng.randn(2, 2).astype(np.float32)}
    jhvd.init()
    try:
        js = jelastic.State(step=5, params=copy.deepcopy(tree))
        js.enable_sharded_checkpoint(str(tmp_path / "jax"))
        js.commit()
        assert js.flush_checkpoints(15.0)
        js.close()
    finally:
        jhvd.shutdown()
    ts = telastic.State(step=5, params={
        k: (torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else
            {kk: torch.from_numpy(vv.copy()) for kk, vv in sorted(v.items())})
        for k, v in sorted(tree.items())})
    ts.enable_sharded_checkpoint(str(tmp_path / "port"))
    ts.commit()
    assert ts.flush_checkpoints(15.0)
    ts.close()
    (js_step, jm), (ts_step, tm) = (
        tckpt.latest_sharded_checkpoint(str(tmp_path / d))
        for d in ("jax", "port"))
    assert jm["layout"] == tm["layout"] and jm["digests"] == tm["digests"]
    assert tckpt.unpack_objects(jm) == tckpt.unpack_objects(tm) == {4: 5}
    like = {"params": ts.params, "step": 0}
    step, restored = tckpt.restore_latest_sharded(str(tmp_path / "jax"),
                                                  like)
    assert step == js_step and restored["step"] == 5
    assert torch.equal(restored["params"]["alpha"]["w"],
                       torch.from_numpy(tree["alpha"]["w"]))
    step, jrestored = jckpt.restore_latest_sharded(
        str(tmp_path / "port"), {"params": tree, "step": 0})
    np.testing.assert_array_equal(jrestored["params"]["zeta"], tree["zeta"])


def test_bfloat16_leaf_is_refused_with_its_name(tmp_path, port_state):
    state = telastic.State(step=0, params={
        "w": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)})
    state.enable_sharded_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="params/w.*bfloat16"):
        state.commit()
    state.close()
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.save_shard(str(tmp_path), 1, 0, 1,
                         [torch.ones(2, dtype=torch.bfloat16)])


# ---------------------------------------------------------------------------
# The sharded torn-save matrix and the async writer


def test_sharded_torn_save_matrix_every_rename_point(tmp_path):
    d = str(tmp_path)
    leaves_v1 = [np.arange(6, dtype=np.float32), np.ones(2, np.float32)]
    _write_step(tckpt, d, 1, 2, leaves_v1)
    leaves_v2 = [a + 10 for a in leaves_v1]
    layout = tckpt.shard_layout([a.nbytes for a in leaves_v2], 2)
    digests = [tckpt.shard_digest([leaves_v2[i] for i in layout[k]])
               for k in range(2)]
    manifest = {"step": 2, "epoch": 2, "world_size": 2, "layout": layout,
                "digests": digests, "objects_hex": tckpt.pack_objects({})}

    def check_resumes_v1():
        step, tree = tckpt.restore_latest_sharded(d, list(leaves_v1))
        assert step == 1, f"torn step 2 must not win (got {step})"
        for x, y in zip(leaves_v1, tree):
            np.testing.assert_array_equal(x, y)

    os.makedirs(tmp_path / "sharded_2.shard0of2.tmp.999")
    check_resumes_v1()
    tckpt.save_shard(d, 2, 0, 2, [leaves_v2[i] for i in layout[0]])
    check_resumes_v1()
    tckpt.save_shard(d, 2, 1, 2, [leaves_v2[i] for i in layout[1]])
    os.makedirs(tmp_path / "sharded_2.manifest.tmp.999")
    check_resumes_v1()
    shutil.rmtree(tmp_path / "sharded_2.shard1of2")
    tckpt.write_manifest(d, 2, manifest)
    check_resumes_v1()
    tckpt.save_shard(d, 2, 1, 2, [leaves_v2[i] for i in layout[1]])
    step, tree = tckpt.restore_latest_sharded(d, list(leaves_v1))
    assert step == 2
    for x, y in zip(leaves_v2, tree):
        np.testing.assert_array_equal(x, y)


def test_corrupt_shard_bytes_fall_back_to_previous_step(tmp_path):
    d = str(tmp_path)
    leaves = [np.arange(4, dtype=np.float32)]
    _write_step(tckpt, d, 1, 1, leaves)
    _write_step(tckpt, d, 2, 1, [leaves[0] + 5])
    with open(os.path.join(tckpt.shard_path(d, 2, 0, 1), "shard.bin"),
              "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff")
    step, tree = tckpt.restore_latest_sharded(d, list(leaves))
    assert step == 1
    np.testing.assert_array_equal(tree[0], leaves[0])


def test_async_writer_persists_and_prunes(tmp_path):
    w = tckpt.AsyncShardWriter(str(tmp_path), keep=2)
    leaves = [np.arange(5, dtype=np.float32)]
    for step in (1, 2, 3, 4):
        arrays = [torch.from_numpy(leaves[0] + step)]
        w.submit(step, 0, 1, arrays,
                 manifest={"step": step, "epoch": 1, "world_size": 1,
                           "layout": [[0]],
                           "digests": [tckpt.shard_digest(arrays)],
                           "objects_hex": tckpt.pack_objects({})})
        assert w.flush(10.0), "writer never drained"
    names = sorted(os.listdir(tmp_path))
    assert not any(".tmp." in n for n in names)
    assert {n.split(".")[0] for n in names} == {"sharded_3", "sharded_4"}
    step, tree = tckpt.restore_latest_sharded(str(tmp_path), list(leaves))
    assert step == 4
    np.testing.assert_array_equal(tree[0], leaves[0] + 4)
    w2 = tckpt.AsyncShardWriter(str(tmp_path), keep=2)
    assert w2.next_step() == 5
    w.close()
    w2.close()


def test_prune_never_deletes_the_newest_complete_step(tmp_path):
    d = str(tmp_path)
    leaves = [np.arange(4, dtype=np.float32), np.ones(2, np.float32)]
    _write_step(tckpt, d, 1, 2, leaves)
    layout = tckpt.shard_layout([a.nbytes for a in leaves], 2)
    for step in (2, 3, 4):
        tckpt.save_shard(d, step, 0, 2, [leaves[i] for i in layout[0]])
    w = tckpt.AsyncShardWriter(d, keep=2)
    w._prune(4)
    assert tckpt.latest_sharded_checkpoint(d)[0] == 1
    assert os.path.isdir(tmp_path / "sharded_1.shard1of2")
    _write_step(tckpt, d, 5, 2, [a + 1 for a in leaves])
    w._prune(5)
    assert "sharded_1" not in {n.split(".")[0] for n in os.listdir(d)}
    assert tckpt.latest_sharded_checkpoint(d)[0] == 5
    w.close()


def test_async_writer_latest_wins_drops_intermediate(tmp_path, monkeypatch):
    w = tckpt.AsyncShardWriter(str(tmp_path), keep=2)
    gate = threading.Event()
    persisted = []
    orig = tckpt.AsyncShardWriter._persist

    def slow_persist(self, snap):
        gate.wait(10.0)
        persisted.append(snap["step"])
        orig(self, snap)

    monkeypatch.setattr(tckpt.AsyncShardWriter, "_persist", slow_persist)
    arr = [np.ones(3, np.float32)]
    w.submit(1, 0, 1, arr)
    time.sleep(0.1)
    w.submit(2, 0, 1, arr)
    w.submit(3, 0, 1, arr)
    gate.set()
    assert w.flush(10.0)
    assert w.dropped == 1
    assert persisted == [1, 3], persisted
    w.close()


def test_async_writer_survives_a_raising_save(tmp_path, monkeypatch):
    """A storage error inside the writer thread is kept in
    ``last_error`` and logged, never raised into the step; the next
    snapshot persists."""
    calls = []
    orig = tckpt.save_shard

    def failing_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk full")
        return orig(*args, **kwargs)

    monkeypatch.setattr(tckpt, "save_shard", failing_once)
    w = tckpt.AsyncShardWriter(str(tmp_path), keep=2)
    arr = [np.ones(2, np.float32)]
    w.submit(1, 0, 1, arr)
    assert w.flush(10.0)
    assert isinstance(w.last_error, OSError) and w.written_steps == 0
    w.submit(2, 0, 1, arr)
    assert w.flush(10.0)
    assert w.written_steps == 1
    w.close()


def test_writer_metrics_register_and_count(tmp_path):
    from horovod_tpu_torch import metrics

    metrics.reset_for_tests()
    metrics.enable()
    try:
        w = tckpt.AsyncShardWriter(str(tmp_path), keep=2)
        w.submit(1, 0, 1, [np.ones(4, np.float32)])
        assert w.flush(10.0)
        w.close()
        snap = metrics.snapshot()
        assert set(snap) >= {"hvd_ckpt_commits_total",
                             "hvd_ckpt_written_bytes_total",
                             "hvd_ckpt_write_seconds",
                             "hvd_ckpt_dropped_commits_total"}
    finally:
        metrics.reset_for_tests()


# ---------------------------------------------------------------------------
# elastic.State


def test_elastic_state_commit_restore_semantics(port_state):
    state = thvd.elastic.State(step=3, weights=torch.arange(4.0))
    assert state.step == 3
    state.step = 10
    state.weights = state.weights + 1
    state.restore()
    assert state.step == 3
    assert torch.equal(state.weights, torch.arange(4.0))
    state.step = 10
    state.commit()
    state.step = 99
    state.restore()
    assert state.step == 10
    assert thvd.elastic.epoch() == 1
    with pytest.raises(ValueError):
        thvd.elastic.State()


def test_restore_is_one_materialization_per_value(port_state, monkeypatch):
    state = thvd.elastic.State(step=1, weights=np.arange(4.0))
    calls = []
    orig = copy.deepcopy
    monkeypatch.setattr(telastic.copy, "deepcopy",
                        lambda x, *a: (calls.append(1), orig(x, *a))[1])
    state.restore()
    assert len(calls) == 2, calls
    state.weights[0] = 99.0
    state.restore()
    assert state.weights[0] == 0.0


def test_state_construction_before_init_stays_local():
    code = ("import numpy as np\n"
            "import horovod_tpu_torch as hvd\n"
            "state = hvd.elastic.State(step=0, weights=np.zeros(4))\n"
            "state.step = 5\n"
            "state.commit()\n"
            "print('PREINIT_OK', state._commit_world)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    for scrub in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CKPT_DIR",
                  "HOROVOD_CONTROLLER_ADDR", "HOROVOD_SPMD_COORDINATOR",
                  "HOROVOD_RENDEZVOUS_FILE"):
        env.pop(scrub, None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PREINIT_OK 1" in res.stdout


def test_state_commit_feeds_async_writer(tmp_path, port_state, monkeypatch):
    monkeypatch.setenv("HOROVOD_CKPT_DIR", str(tmp_path))
    state = thvd.elastic.State(step=0,
                               weights=torch.arange(6, dtype=torch.float32))
    for s in range(1, 4):
        state.step = s
        state.weights = state.weights + 1
        state.commit()
    assert state.flush_checkpoints(15.0)
    assert state.checkpoint_dir == str(tmp_path)
    step, manifest = tckpt.latest_sharded_checkpoint(str(tmp_path))
    assert manifest["world_size"] == 1
    leaves = tckpt.load_shard(tckpt.shard_path(str(tmp_path), step, 0, 1),
                              expect_digest=manifest["digests"][0])
    np.testing.assert_array_equal(
        leaves[0], np.arange(6, dtype=np.float32) + 3)
    values = sorted(tckpt.unpack_objects(manifest).values())
    assert 3 in values and all(isinstance(v, int) for v in values)
    state.close()


def test_run_restores_and_retries_on_ranks_changed(port_state):
    state = thvd.elastic.State(step=0)
    tries = []

    @thvd.elastic.run
    def train(s):
        tries.append(s.step)
        s.step += 5
        if len(tries) == 1:
            raise thvd.elastic.RanksChangedError("a rank left")
        return s.step

    assert train(state) == 5 and tries == [0, 0]
    with pytest.raises(KeyError):
        thvd.elastic.run(lambda s: {}["x"])(state)


# ---------------------------------------------------------------------------
# Two ranks: the broadcast from rank 0

WORKER = WORKER_HEAD + '''
import os

import horovod_tpu_torch.elastic as elastic
from horovod_tpu_torch.utils import checkpoint as ckpt


def main():
    hvd.init(device="cpu")
    arrays, specs = load_cases()
    r = hvd.rank()
    res = {}
    # Each rank reads its own file, written with its own values: the
    # broadcast makes rank 0's the result everywhere.
    tree = ckpt.restore_checkpoint(specs["paths"][r])
    res["ckpt/w"] = tree["w"]
    res["ckpt/step"] = np.array(tree["step"])
    res["ckpt/int"] = tree["int"]
    state = elastic.State(step=r + 1, tag=f"rank{r}",
                          weights={"w": torch.full((3,), float(r)),
                                   "b": np.full(2, r, np.int64)})
    state.step, state.weights = 77, {"w": torch.zeros(3),
                                     "b": np.zeros(2, np.int64)}
    state.restore()
    res["state/step"] = np.array(state.step)
    res["state/tag"] = np.array(state.tag)
    res["state/w"] = state.weights["w"]
    res["state/b"] = state.weights["b"]
    save(res)
    hvd.shutdown()
    print("worker ok")


if __name__ == "__main__":
    main()
'''


def test_two_ranks_take_rank0s_values(tmp_path):
    paths = []
    for r in range(2):
        path = str(tmp_path / f"r{r}" / "ckpt_1")
        os.makedirs(os.path.dirname(path))
        tckpt.save_checkpoint(path, {"w": torch.full((4,), 10.0 + r),
                                     "step": 100 + r,
                                     "int": torch.full((3,), r)})
        paths.append(path)
    ranks = run_job(tmp_path / "job", 2, WORKER, {}, {"paths": paths})
    for out in ranks:
        np.testing.assert_array_equal(out["ckpt/w"], np.full(4, 10.0))
        assert int(out["ckpt/step"]) == 100
        np.testing.assert_array_equal(out["ckpt/int"], np.zeros(3))
        assert int(out["state/step"]) == 1
        assert str(out["state/tag"]) == "rank0"
        np.testing.assert_array_equal(out["state/w"], np.zeros(3))
        np.testing.assert_array_equal(out["state/b"], np.zeros(2))
