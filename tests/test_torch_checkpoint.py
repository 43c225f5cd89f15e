"""The port's train-state checkpoints (``paddle_tpu_torch.distributed``)
against the reference's format, and their crash-safety contract.

- Cross-package: a mixed tree (f32, bf16, int32, int64, 0-d, numpy
  scalar and JSON literals) written by the port is read by
  ``paddle_tpu.distributed.checkpoint.load_state_dict`` and the reverse,
  bit-equal (the reference reads int64 under ``jax.enable_x64``); a tree
  the reference wrote sharded over 2 of the 8 host devices loads whole.
- The reference's corruption, kill-point and async cases
  (``tests/test_checkpoint.py``), run on the port; and the port's own:
  a state updated in place right after ``async_save`` returns is
  written as it was at the save.
- ``CheckpointManager``: retention, auto_resume / restore past corrupt
  checkpoints, staging GC, the bounded async queue, the SIGTERM hook.
"""
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from paddle_tpu.distributed import checkpoint as ref_ckpt

from paddle_tpu_torch.common.errors import CorruptCheckpointError
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.checkpoint import (
    ChaosCrash, clear_chaos, get_checkpoint_metadata, load_state_dict,
    save_state_dict, set_chaos, validate_checkpoint)
from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
from paddle_tpu_torch.observability import get_registry


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    clear_chaos()


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "h": rng.standard_normal((2, 5)).astype(np.float32),
            "i32": rng.integers(-2 ** 31, 2 ** 31, 6).astype(np.int32),
            "i64": rng.integers(-2 ** 62, 2 ** 62, 3).astype(np.int64),
            "s": np.float32(rng.standard_normal())}


LITERALS = {"step": 7, "name": "adamw", "none": None, "flag": True,
            "rate": 0.25}


def _bits(x):
    """The raw bytes of an array or tensor (bf16 by its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return x.tobytes()


def test_port_writes_reference_reads(tmp_path):
    a = _arrays(1)
    state = {"w": torch.from_numpy(a["w"]),
             "h": torch.from_numpy(a["h"]).bfloat16(),
             "i32": torch.from_numpy(a["i32"]),
             "i64": torch.from_numpy(a["i64"]),
             "s": torch.tensor(a["s"]), "np": a["s"],
             "nested": dict(LITERALS), "lst": [torch.from_numpy(a["w"][0])]}
    save_state_dict(state, str(tmp_path / "ck"))
    with jax.enable_x64(True):
        tmpl = {"w": np.zeros((3, 4), np.float32),
                "h": jnp.zeros((2, 5), jnp.bfloat16),
                "i32": np.zeros(6, np.int32), "i64": np.zeros(3, np.int64),
                "s": np.float32(0), "np": np.float32(0),
                "nested": {k: None for k in LITERALS},
                "lst": [np.zeros(4, np.float32)]}
        out = ref_ckpt.load_state_dict(tmpl, str(tmp_path / "ck"))
        for k in ("w", "h", "i32", "i64", "s"):
            assert _bits(out[k]) == _bits(state[k]), k
            assert np.asarray(out[k]).shape == tuple(state[k].shape)
        assert str(np.asarray(out["i64"]).dtype) == "int64"
    assert _bits(out["np"]) == _bits(a["s"])
    assert _bits(out["lst"][0]) == _bits(state["lst"][0])
    assert out["nested"] == LITERALS


def test_reference_writes_port_reads(tmp_path):
    a = _arrays(2)
    state = {"w": jnp.asarray(a["w"]),
             "h": jnp.asarray(a["h"]).astype(jnp.bfloat16),
             "i32": jnp.asarray(a["i32"]), "i64": a["i64"],
             "s": jnp.asarray(a["s"]), "np": a["s"],
             "nested": dict(LITERALS), "lst": [jnp.asarray(a["w"][1])]}
    ref_ckpt.save_state_dict(state, str(tmp_path / "ck"))
    tmpl = {"w": torch.zeros(3, 4), "h": torch.zeros(2, 5,
                                                     dtype=torch.bfloat16),
            "i32": torch.zeros(6, dtype=torch.int32),
            "i64": torch.zeros(3, dtype=torch.int64),
            "s": torch.zeros(()), "np": np.float32(0),
            "nested": {k: 0 for k in LITERALS}, "lst": [torch.zeros(4)]}
    keep = tmpl["h"]
    out = load_state_dict(tmpl, str(tmp_path / "ck"))
    assert out["h"] is keep                 # tensors are filled in place
    for k in ("w", "h", "i32", "i64", "s", "np"):
        assert _bits(out[k]) == _bits(state[k]), k
    assert _bits(out["lst"][0]) == _bits(state["lst"][0])
    assert out["nested"] == LITERALS


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_reference_sharded_over_two_devices_loads_whole(tmp_path, dtype):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("x",))
    a = np.arange(32, dtype=np.float32).reshape(8, 4) / 7
    xs = jax.device_put(jnp.asarray(a).astype(dtype),
                        NamedSharding(mesh, PartitionSpec("x")))
    ref_ckpt.save_state_dict({"w": xs}, str(tmp_path / "ck"))
    meta = get_checkpoint_metadata(str(tmp_path / "ck"))
    assert len(meta["arrays"]["w"]["chunks"]) == 2
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out = load_state_dict({"w": torch.zeros(8, 4, dtype=tdt)},
                          str(tmp_path / "ck"))
    assert _bits(out["w"]) == _bits(np.asarray(xs))


def _chunk_files(path):
    meta = get_checkpoint_metadata(str(path))
    return [os.path.join(str(path), c["file"])
            for e in meta["arrays"].values() for c in e["chunks"]]


def _staging(tmp_path):
    return [d for d in os.listdir(tmp_path) if ".tmp-" in d]


def _x(v):
    return {"x": torch.full((6,), float(v))}


def _load_x(path):
    return load_state_dict({"x": torch.zeros(6)}, str(path))["x"]


def test_manifest_is_committed_with_sha256(tmp_path):
    save_state_dict(_x(1), str(tmp_path / "ck"))
    meta = get_checkpoint_metadata(str(tmp_path / "ck"))
    assert meta["committed"] is True and meta["version"] == 2
    for entry in meta["arrays"].values():
        for chunk in entry["chunks"]:
            assert len(chunk["sha256"]) == 64 and chunk["bytes"] > 0
    validate_checkpoint(str(tmp_path / "ck"))
    # the reference validates the port's checkpoint too
    ref_ckpt.validate_checkpoint(str(tmp_path / "ck"))


def test_resave_same_dir_commits_atomically(tmp_path):
    save_state_dict(_x(1), str(tmp_path / "ck"))
    save_state_dict(_x(2), str(tmp_path / "ck"))
    assert torch.equal(_load_x(tmp_path / "ck"), torch.full((6,), 2.0))
    assert len([d for d in os.listdir(tmp_path / "ck")
                if d.startswith("data-")]) == 1


@pytest.mark.parametrize("point", ["pre-rename", "pre-manifest"])
def test_kill_on_fresh_save_never_visible(tmp_path, point):
    """A crash before the commit rename leaves no checkpoint dir (never a
    torn one); the next successful save sweeps the orphan."""
    set_chaos(point)
    with pytest.raises(ChaosCrash):
        save_state_dict(_x(1), str(tmp_path / "ck"))
    assert not (tmp_path / "ck").exists()
    assert len(_staging(tmp_path)) == 1 and ckpt.staging_dirs_alive()
    with pytest.raises(CorruptCheckpointError):
        get_checkpoint_metadata(str(tmp_path / "ck"))
    save_state_dict(_x(2), str(tmp_path / "ck"))
    assert not _staging(tmp_path)
    assert torch.equal(_load_x(tmp_path / "ck"), torch.full((6,), 2.0))


def test_kill_mid_chunk_resave_keeps_old_checkpoint(tmp_path):
    save_state_dict(_x(1), str(tmp_path / "ck"))
    set_chaos("mid-chunk")
    with pytest.raises(ChaosCrash):
        save_state_dict(_x(10), str(tmp_path / "ck"))
    validate_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(_load_x(tmp_path / "ck"), torch.full((6,), 1.0))
    save_state_dict(_x(10), str(tmp_path / "ck"))
    assert not _staging(tmp_path)
    assert torch.equal(_load_x(tmp_path / "ck"), torch.full((6,), 10.0))


def test_kill_post_commit_checkpoint_already_valid(tmp_path):
    save_state_dict(_x(1), str(tmp_path / "ck"))
    set_chaos("post-commit")
    with pytest.raises(ChaosCrash):
        save_state_dict(_x(3), str(tmp_path / "ck"))
    validate_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(_load_x(tmp_path / "ck"), torch.full((6,), 3.0))
    datadirs = lambda: [d for d in os.listdir(tmp_path / "ck")  # noqa
                        if d.startswith("data-")]
    assert len(datadirs()) == 2
    save_state_dict(_x(4), str(tmp_path / "ck"))
    assert len(datadirs()) == 1


def _truncate(f):
    with open(f, "r+b") as fh:
        fh.truncate(os.path.getsize(f) // 2)


def _bitflip(f):
    with open(f, "r+b") as fh:
        fh.seek(os.path.getsize(f) - 7)
        b = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "remove"])
def test_damaged_chunk_raises_typed_error(tmp_path, damage):
    save_state_dict({"x": torch.arange(64, dtype=torch.float32)},
                    str(tmp_path / "ck"))
    f = _chunk_files(tmp_path / "ck")[0]
    {"truncate": _truncate, "bitflip": _bitflip, "remove": os.remove}[
        damage](f)
    with pytest.raises(CorruptCheckpointError):
        validate_checkpoint(str(tmp_path / "ck"))
    with pytest.raises(CorruptCheckpointError):
        load_state_dict({"x": torch.zeros(64)}, str(tmp_path / "ck"))
    if damage == "bitflip":
        # a size-only validation misses a bit flip by design
        validate_checkpoint(str(tmp_path / "ck"), deep=False)


def test_missing_and_torn_metadata_typed_error(tmp_path):
    save_state_dict(_x(1), str(tmp_path / "ck"))
    mpath = tmp_path / "ck" / "metadata.json"
    data = mpath.read_bytes()
    mpath.write_bytes(data[:len(data) // 2])
    with pytest.raises(CorruptCheckpointError):
        get_checkpoint_metadata(str(tmp_path / "ck"))
    os.remove(mpath)
    with pytest.raises(CorruptCheckpointError):
        get_checkpoint_metadata(str(tmp_path / "ck"))


def test_template_untouched_on_corrupt_load(tmp_path):
    """Verification fails before any template leaf changes."""
    save_state_dict({"a": torch.arange(16, dtype=torch.float32),
                     "b": torch.ones(16), "n": 3}, str(tmp_path / "ck"))
    files = sorted(_chunk_files(tmp_path / "ck"))
    with open(files[-1], "r+b") as fh:
        fh.seek(-3, os.SEEK_END)
        fh.write(b"\xff")
    tmpl = {"a": torch.zeros(16), "b": torch.zeros(16), "n": 0}
    with pytest.raises(CorruptCheckpointError):
        load_state_dict(tmpl, str(tmp_path / "ck"))
    assert torch.equal(tmpl["a"], torch.zeros(16))
    assert torch.equal(tmpl["b"], torch.zeros(16)) and tmpl["n"] == 0


def test_async_success_wait_and_bytes(tmp_path):
    h = save_state_dict({"x": torch.arange(256, dtype=torch.float32)},
                        str(tmp_path / "ck"), async_save=True)
    assert h.wait(timeout=60) is True
    assert h.done() and h.exception() is None
    assert h.bytes_written > 256 * 4
    validate_checkpoint(str(tmp_path / "ck"))


def test_async_wait_surfaces_writer_failure(tmp_path):
    set_chaos("pre-rename")
    h = save_state_dict(_x(1), str(tmp_path / "ck"), async_save=True)
    with pytest.raises(ChaosCrash):
        h.wait(timeout=60)
    assert not (tmp_path / "ck").exists()
    save_state_dict(_x(1), str(tmp_path / "ck"))


def test_async_unwaited_failure_surfaces_at_next_save(tmp_path):
    set_chaos("pre-rename")
    h = save_state_dict(_x(1), str(tmp_path / "ck"), async_save=True)
    deadline = time.monotonic() + 60
    while not h.done() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert h.done()
    with pytest.raises(RuntimeError) as ei:
        save_state_dict(_x(2), str(tmp_path / "ck2"))
    assert isinstance(ei.value.__cause__, ChaosCrash)
    save_state_dict(_x(1), str(tmp_path / "ck"))
    validate_checkpoint(str(tmp_path / "ck"))


def test_async_save_snapshots_before_it_returns(tmp_path):
    """The state is updated in place at once after ``async_save``
    returns (as the next train step would); the checkpoint holds the
    state as it was at the save."""
    state = {"p": torch.arange(4096, dtype=torch.float32),
             "m": {"moment1": torch.ones(64, 64)},
             "step": torch.tensor(3, dtype=torch.int32)}
    want = {"p": state["p"].clone(), "m": state["m"]["moment1"].clone()}
    h = save_state_dict(state, str(tmp_path / "ck"), async_save=True)
    state["p"].add_(1.0)
    state["m"]["moment1"].mul_(-2.0)
    state["step"].add_(1)
    h.wait(timeout=60)
    tmpl = {"p": torch.zeros(4096), "m": {"moment1": torch.zeros(64, 64)},
            "step": torch.zeros((), dtype=torch.int32)}
    load_state_dict(tmpl, str(tmp_path / "ck"))
    assert torch.equal(tmpl["p"], want["p"])
    assert torch.equal(tmpl["m"]["moment1"], want["m"])
    assert int(tmpl["step"]) == 3


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def _bitflip_first_chunk(path):
    _bitflip(_chunk_files(path)[0])


@pytest.mark.parametrize("kw,want", [
    ({"keep_last_n": 2}, [4, 5]),
    ({"keep_last_n": 1, "keep_every_k": 2}, [2, 4, 5])])
def test_manager_retention(tmp_path, kw, want):
    m = CheckpointManager(str(tmp_path), **kw)
    for s in range(1, 6):
        m.save(_x(s), s)
    assert m.steps_on_disk() == want
    assert torch.equal(_load_x(m.step_dir(5)), torch.full((6,), 5.0))


def test_manager_auto_resume_falls_back_past_corrupt(tmp_path):
    m = CheckpointManager(str(tmp_path))
    assert m.auto_resume() is None and m.restore(_x(0)) is None
    m.save(_x(1), 1)
    m.save(_x(2), 2)
    assert m.auto_resume() == (2, m.step_dir(2))
    _bitflip_first_chunk(m.step_dir(2))
    before = get_registry().counter("ckpt_corruption_total").value
    assert m.auto_resume() == (1, m.step_dir(1))
    assert get_registry().counter(
        "ckpt_corruption_total").value == before + 1
    tmpl = _x(0)
    assert m.restore(tmpl) == (1, None)
    assert torch.equal(tmpl["x"], torch.full((6,), 1.0))
    _bitflip_first_chunk(m.step_dir(1))
    assert m.auto_resume() is None and m.restore(_x(0)) is None


def test_manager_gc_stale_sweeps_staging(tmp_path):
    m = CheckpointManager(str(tmp_path))
    dead = tmp_path / "step_00000007.tmp-deadbeef"
    dead.mkdir()
    (dead / "junk.npy").write_bytes(b"x")
    swept = m.gc_stale()
    assert [os.path.basename(p) for p in swept] == [dead.name]
    assert not dead.exists() and m.steps_on_disk() == []


def test_manager_bounded_async_queue(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last_n=5, async_save=True,
                          max_inflight=1)
    for s in range(1, 4):
        assert m.save(_x(s), s) is not None
    m.wait()
    assert m.steps_on_disk() == [1, 2, 3]
    assert get_registry().gauge("ckpt_async_queue_depth").value == 0
    for s in range(1, 4):
        validate_checkpoint(m.step_dir(s))


@pytest.mark.parametrize("where", ["next_save", "wait"])
def test_manager_async_failure_surfaces(tmp_path, where):
    m = CheckpointManager(str(tmp_path), async_save=True)
    set_chaos("pre-rename")
    h = m.save(_x(1), 1)
    if where == "next_save":
        deadline = time.monotonic() + 60
        while not h.done() and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(ChaosCrash):
            m.save(_x(2), 2)
    else:
        with pytest.raises(ChaosCrash):
            m.wait()
    m.gc_stale()
    m.save(_x(3), 3)
    m.wait()
    assert 3 in m.steps_on_disk()


def test_manager_sigterm_sets_flag_and_restores_handler(tmp_path):
    m = CheckpointManager(str(tmp_path))
    calls = []
    prev = signal.getsignal(signal.SIGTERM)
    m.install_preemption_hook(on_preempt=lambda: calls.append(1))
    try:
        assert m.preempted is False
        signal.raise_signal(signal.SIGTERM)
        assert m.preempted is True and calls == [1]
    finally:
        m.uninstall_preemption_hook()
    assert signal.getsignal(signal.SIGTERM) is prev
