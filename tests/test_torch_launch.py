"""The port's process-group runtime on the CPU: the launcher
(rendezvous over 2 ranks, elastic relaunch, fail-fast exit code, two
controllers as two nodes), ``spawn``, the TCPStore (native and python
ends against each other's servers, the reference's too, and as c10d's
store), the environment, fleet's refusals, and the build locks that let
ranks starting together on a fresh tree build a library once.

Mirrors the reference's ``tests/test_launch.py``,
``tests/test_distributed_round5.py``'s spawn case and the store cases of
``tests/test_native.py``.
"""
import os
import struct
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from paddle_tpu.distributed.store import TCPStore as RefStore
from paddle_tpu.distributed.store import _PyClient as RefPyClient

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.core import load_native
from paddle_tpu_torch.distributed import env, fleet
from paddle_tpu_torch.distributed.launch import Controller, LaunchConfig
from paddle_tpu_torch.distributed.launch import controller as ctl
from paddle_tpu_torch.distributed.launch import free_port
from paddle_tpu_torch.distributed.store import (C10dStore, TCPStore,
                                                _PyClient, _PyServer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    env_ = dict(os.environ)
    for k in list(env_):
        if k.startswith(("PADDLE_", "XLA_", "JAX_", "FLAGS_")):
            env_.pop(k)
    env_["PYTHONPATH"] = REPO + os.pathsep + env_.get("PYTHONPATH", "")
    return env_


def _tail_logs(logdir, n=2000):
    out = ""
    if os.path.isdir(logdir):
        for f in sorted(os.listdir(logdir)):
            with open(os.path.join(logdir, f)) as fh:
                out += f"\n--- {f}\n" + fh.read()[-n:]
    return out


RENDEZVOUS = textwrap.dedent('''
    import os, sys, torch
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env(device="cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    t = dist.all_reduce(torch.tensor([float(r + 1)]))
    pe = dist.ParallelEnv()
    assert pe.rank == r and pe.world_size == n
    assert os.environ["PADDLE_STORE_HOSTED"] == "1"
    if r == 0:
        with open(os.path.join(sys.argv[1], "result.txt"), "w") as f:
            f.write(f"sum={float(t[0])} world={n} "
                    f"backend={dist.get_backend()} "
                    f"native={dist.env.get_store().is_native}")
    dist.barrier()
    dist.destroy_process_group()
''')


def _launch(args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *args], env=_clean_env(), cwd=REPO, capture_output=True,
        text=True, timeout=timeout)


def test_two_process_rendezvous(tmp_path):
    script = tmp_path / "rdv.py"
    script.write_text(RENDEZVOUS)
    out = _launch(["--nproc_per_node", "2", "--log_dir",
                   str(tmp_path / "logs"), str(script), str(tmp_path)])
    assert out.returncode == 0, out.stderr + _tail_logs(tmp_path / "logs")
    assert (tmp_path / "result.txt").read_text() == \
        "sum=3.0 world=2 backend=gloo native=True"


def test_launch_elastic_relaunches_failed_gang(tmp_path):
    script = tmp_path / "flaky.py"
    marker = tmp_path / "crashed_once"
    script.write_text(
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').write('x')\n"
        "    sys.exit(1)\n"
        "sys.exit(0)\n")
    out = _launch(["--nproc_per_node", "2", "--elastic_level", "1",
                   "--max_restarts", "2", str(script)])
    assert out.returncode == 0, out.stderr
    assert "relaunching" in out.stderr


def test_launch_fail_fast_propagates_exit_code(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text("import sys; sys.exit(7)\n")
    out = _launch(["--nproc_per_node", "2", str(script)])
    assert out.returncode == 7


def test_multi_node_two_controllers(tmp_path):
    """nnodes=2: one controller a node, one master address; node 0's
    controller hosts the store, both workers join one gang."""
    script = tmp_path / "rdv.py"
    script.write_text(RENDEZVOUS)
    master = f"127.0.0.1:{free_port()}"
    procs = []
    try:
        for rank in (0, 1):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                 "--nnodes", "2", "--node_rank", str(rank),
                 "--nproc_per_node", "1", "--master", master,
                 "--log_dir", str(tmp_path / f"logs{rank}"), str(script),
                 str(tmp_path)], env=_clean_env(), cwd=REPO))
        deadline = time.monotonic() + 120
        codes = [p.wait(timeout=max(1, deadline - time.monotonic()))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = "".join(_tail_logs(tmp_path / f"logs{r}") for r in (0, 1))
    assert codes == [0, 0], logs
    assert (tmp_path / "result.txt").read_text().startswith(
        "sum=3.0 world=2 backend=gloo")


def test_spawn_two_processes_all_reduce(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'tests'); "
         "import torch_dist_worker as w; w.spawn_main(sys.argv[1])",
         str(tmp_path)], env=_clean_env(), cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SPAWN_OK" in out.stdout
    for r in (0, 1):
        assert (tmp_path / f"spawn{r}").read_text() == "3.0 2 gloo"


def test_worker_env():
    c = Controller(LaunchConfig(script="x.py", nnodes=2, node_rank=1,
                                nproc_per_node=2, master="10.0.0.1:7000"))
    e = c._worker_env(1)
    assert (e["PADDLE_TRAINER_ID"], e["PADDLE_TRAINERS_NUM"],
            e["PADDLE_LOCAL_RANK"], e["PADDLE_MASTER"],
            e["PADDLE_STORE_HOSTED"]) == ("3", "4", "1", "10.0.0.1:7000",
                                          "1")


@pytest.mark.parametrize("loopback_only,preset,want", [
    (True, None, "lo"), (True, "eth9", "eth9"), (False, None, None)])
def test_nccl_socket_ifname(monkeypatch, loopback_only, preset, want):
    monkeypatch.setattr(ctl, "_only_loopback", lambda: loopback_only)
    monkeypatch.delenv("NCCL_SOCKET_IFNAME", raising=False)
    if preset:
        monkeypatch.setenv("NCCL_SOCKET_IFNAME", preset)
    c = Controller(LaunchConfig(script="x.py", master="127.0.0.1:1"))
    assert c._worker_env(0).get("NCCL_SOCKET_IFNAME") == want


# -- the store ------------------------------------------------------------------

def test_native_library_builds_with_the_store():
    lib = load_native()
    assert lib is not None and hasattr(lib, "tcp_store_server_start")


def test_store_set_get_add_check_delete():
    master = TCPStore("127.0.0.1", 0, world_size=2, is_master=True)
    client = TCPStore("127.0.0.1", master.port, world_size=2)
    assert master.is_native and client.is_native
    master.set("alpha", b"hello")
    assert client.get("alpha") == b"hello"
    assert client.check("alpha") and not client.check("nope")
    assert client.add("ctr", 5) == 5 and master.add("ctr", 2) == 7
    client.set("beta", "text value")
    assert master.get("beta") == b"text value"
    master.delete_key("alpha")
    assert not client.check("alpha")
    with pytest.raises(TimeoutError):
        client.wait("never", timeout_ms=100)
    done = []
    t = threading.Thread(target=lambda: (client.barrier("b0"),
                                         done.append(1)))
    t.start()
    master.barrier("b0")
    t.join(timeout=10)
    assert done == [1]
    client.close()
    master.close()


def _server(kind):
    if kind == "native":
        s = TCPStore("127.0.0.1", 0, is_master=True)
        return s, s.port
    if kind == "python":
        s = _PyServer("127.0.0.1", 0)
        return s, s.port
    s = RefStore("127.0.0.1", 0, is_master=True)     # the reference's
    return s, s.port


def _client(kind, port):
    if kind == "native":
        return TCPStore("127.0.0.1", port)
    if kind == "python":
        return _PyClient("127.0.0.1", port, timeout_s=10)
    return RefPyClient("127.0.0.1", port, timeout_s=10)


@pytest.mark.parametrize("server", ["native", "python", "reference"])
@pytest.mark.parametrize("client", ["native", "python", "reference"])
def test_store_ends_speak_one_protocol(server, client):
    srv, port = _server(server)
    holder = _client(client, port)
    c = getattr(holder, "_client", holder)
    c._req(0, b"k", 3, b"xyz")                            # SET
    assert c._req(1, b"k", 0) == b"xyz"                   # GET
    assert struct.unpack("<q", c._req(2, b"n", 4))[0] == 4  # ADD
    assert c._req(5, b"k", 0) == b"1"                     # CHECK
    c.close()
    if server == "python":
        srv.stop()


def test_store_as_c10d_store():
    master = TCPStore("127.0.0.1", 0, is_master=True, timeout=5)
    s = C10dStore(master)
    s.set("a", "1")
    assert s.get("a") == b"1" and s.check(["a"]) and not s.check(["b"])
    assert s.add("c", 3) == 3
    s.wait(["a"])
    assert s.multi_get(["a"]) == [b"1"]
    s.append("a", "2")
    assert s.get("a") == b"12"
    assert s.delete_key("a") and not s.check(["a"])
    clone = s.clone()
    assert clone.get("c") == master.get("c")
    master.close()


# -- environment, fleet, sampler ---------------------------------------------------

def test_parallel_env_reads_the_launch_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_LOCAL_RANK", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2,c:3,d:4")
    pe = dist.ParallelEnv()
    assert (pe.rank, pe.world_size, pe.local_rank, pe.device_id,
            pe.current_endpoint) == (3, 4, 1, 1, "d:4")
    monkeypatch.setenv("FLAGS_selected_gpus", "5,6")
    assert pe.device_id == 5
    from paddle_tpu_torch.io import DistributedBatchSampler
    s = DistributedBatchSampler(list(range(10)), 2)
    assert (s.nranks, s.local_rank) == (4, 3)


@pytest.mark.parametrize("knob", ["mp_degree", "pp_degree", "sep_degree",
                                  "ep_degree"])
def test_fleet_knobs_outside_the_slice_raise(knob):
    s = dist.DistributedStrategy()
    s.hybrid_configs = {knob: 2}
    with pytest.raises(NotImplementedError, match="Multi-device"):
        fleet.init(strategy=s, device="cpu")


@pytest.mark.parametrize("call", [
    lambda: dist.topology.serving_mesh(2),
    lambda: dist.sharding.TPShardings(None)], ids=["serving_mesh",
                                                   "tp_shardings"])
def test_tensor_parallel_serving_raises(call):
    with pytest.raises(NotImplementedError, match="Multi-device"):
        call()


# -- build locks ---------------------------------------------------------------------

KERNEL_BUILD = textwrap.dedent('''
    import sys
    from pathlib import Path
    from paddle_tpu_torch.ops import _build
    root = Path(sys.argv[1])
    _build.CSRC = root / "csrc"
    _build.BUILD_DIR = root / "csrc" / "build"
    _build._nvcc = lambda: str(root / "fake_nvcc")
    rep = _build.build(["stub"])
    print("BUILT" if rep["stub"]["seconds"] is not None else "LOADED")
''')

FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    import sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open({log!r}, "a") as f:
        f.write("compile\\n")
    time.sleep(1.0)
    open(out, "w").write("lib")
    print("ptxas info    : Used 1 registers")
''')


def _run_two(cmd, env_=None):
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env_ or _clean_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e
    return [o for o, _ in outs]


def test_kernel_build_lock_compiles_once(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stub.cu").write_text("// stub\n")
    log = tmp_path / "compiles.log"
    nvcc = tmp_path / "fake_nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    script = tmp_path / "build.py"
    script.write_text(KERNEL_BUILD)
    outs = _run_two([sys.executable, str(script), str(tmp_path)])
    assert log.read_text().count("compile") == 1
    assert sorted(o.strip() for o in outs) == ["BUILT", "LOADED"]


NATIVE_BUILD = textwrap.dedent('''
    import sys
    from paddle_tpu_torch.core import build
    build._SRC_DIR, build._LIB_DIR = sys.argv[1], sys.argv[2]
    build._configure = lambda lib: None
    assert build.load_native() is not None
''')


def test_native_build_lock_compiles_once(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "stub.cpp").write_text('extern "C" int stub() { return 1; }\n')
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "compiles.log"
    gxx = bindir / "g++"
    gxx.write_text(f"#!/bin/sh\necho compile >> {log}\nsleep 1\n"
                   f"exec /usr/bin/g++ \"$@\"\n")
    gxx.chmod(0o755)
    script = tmp_path / "build.py"
    script.write_text(NATIVE_BUILD)
    e = _clean_env()
    e["PATH"] = f"{bindir}{os.pathsep}{e['PATH']}"
    _run_two([sys.executable, str(script), str(src), str(tmp_path / "lib")],
             e)
    assert log.read_text().count("compile") == 1
