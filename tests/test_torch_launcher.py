"""The port's ``horovodrun`` (``horovod_tpu_torch.run``) against the JAX
package's (``horovod_tpu.run``): ``parse_hosts`` and ``build_rank_env``
agree on the keys both export; the launcher runs a 2-rank job with
rank-prefixed output, exports the ring data plane's addresses as the
JAX launcher does (the flat ring, and the hierarchical pair for equal
host groups), propagates a rank's failure (tearing the others down),
relaunches under ``--max-restarts``, prints its version, refuses
``--trace`` (a later slice) by name while the elastic flags parse into
the launch, and under ``--spmd`` starts no controller while the eager
default starts one.

The launcher runs in this process (its children are plain ``python -c``
commands where no package is needed), except for the two tier checks,
whose ranks import the port."""

import os
import subprocess
import sys
import time

import pytest

from horovod_tpu.run import launch as jlaunch
from horovod_tpu_torch.run import launch as tlaunch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("hosts,np_", [
    (None, 3), ("localhost:2", 2), ("a:2,b:2", 3), ("a,b:1, c:4 ,", 5),
    ("h1:8", 8)])
def test_parse_hosts_matches_jax(hosts, np_):
    assert tlaunch.parse_hosts(hosts, np_) == jlaunch.parse_hosts(hosts, np_)


def test_parse_hosts_refuses_too_few_slots_like_jax():
    for mod in (tlaunch, jlaunch):
        with pytest.raises(ValueError, match="exceeds total slots"):
            mod.parse_hosts("a:1,b:1", 3)


@pytest.mark.parametrize("spmd", [False, True])
@pytest.mark.parametrize("bind", [False, True])
def test_build_rank_env_matches_jax_on_shared_keys(spmd, bind):
    base = {"PATH": "/bin", "HOROVOD_ELASTIC": "1", "HOROVOD_ENGINE": "x",
            "HOROVOD_CONTROLLER_ADDR": "stale:1", "HOROVOD_RING_ADDRS": "r"}
    args = (base, 3, 4, 1, 2, 1, 2, "10.0.0.1:2222", "ab" * 32, bind)
    got = tlaunch.build_rank_env(*args, spmd=spmd, restart_epoch=2,
                                 spmd_addr="10.0.0.1:3333")
    want = jlaunch.build_rank_env(*args, spmd=spmd, restart_epoch=2)
    device_vars = ("TPU_", "CUDA_")
    shared = sorted((set(got) & set(want)) - {
        k for k in set(got) | set(want) if k.startswith(device_vars)})
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert (set(want) - set(got)) <= {"TPU_VISIBLE_DEVICES",
                                      "TPU_PROCESS_BOUNDS",
                                      "HOROVOD_ENGINE"}
    if spmd:
        assert "HOROVOD_CONTROLLER_ADDR" not in got
        assert got["HOROVOD_SPMD_COORDINATOR"] == "10.0.0.1:2222"
    else:
        # Eager: the star and, on a port of its own, the group's store.
        assert got["HOROVOD_CONTROLLER_ADDR"] == "10.0.0.1:2222"
        assert got["HOROVOD_SPMD_COORDINATOR"] == "10.0.0.1:3333"
    assert "HOROVOD_ELASTIC" not in got
    assert got.get("CUDA_VISIBLE_DEVICES") == ("1" if bind else None)


def _run(capsys, *argv):
    code = tlaunch.main(list(argv))
    out = capsys.readouterr()
    return code, out.out, out.err


PRINT_RANK = ("import os; print('rank', os.environ['HOROVOD_RANK'], "
              "'of', os.environ['HOROVOD_SIZE'], "
              "os.environ['HOROVOD_LOCAL_RANK'], "
              "bool(os.environ.get('HOROVOD_CONTROLLER_ADDR')), "
              "bool(os.environ.get('HOROVOD_SPMD_COORDINATOR')), "
              "len(os.environ.get('HOROVOD_RING_ADDRS', '').split(',')))")


def test_np2_runs_with_rank_prefixed_output(capsys):
    code, out, _ = _run(capsys, "-np", "2", sys.executable, "-c",
                        PRINT_RANK)
    assert code == 0
    # The star, the store, and one ring address a rank.
    assert "[0]: rank 0 of 2 0 True True 2" in out
    assert "[1]: rank 1 of 2 1 True True 2" in out


def test_spmd_exports_the_store_only(capsys):
    code, out, _ = _run(capsys, "-np", "2", "--spmd", sys.executable, "-c",
                        PRINT_RANK)
    assert code == 0
    # No star and no ring ("".split(",") is one empty field).
    assert "[1]: rank 1 of 2 1 False True 1" in out


PRINT_RINGS = ("import json, os; print('rings', json.dumps({k: "
               "os.environ.get('HOROVOD_' + k) for k in ('RANK', "
               "'RING_ADDRS', 'LOCAL_RING_ADDRS', 'CROSS_RING_ADDRS')}))")


def _rings(out):
    import json

    return {int(v["RANK"]): v for v in (
        json.loads(line.split("rings ", 1)[1])
        for line in out.splitlines() if "rings {" in line)}


@pytest.mark.parametrize("launcher", ["port", "jax"])
@pytest.mark.parametrize("hosts,np_,hier", [
    ("localhost:2,127.0.0.1:2", 4, True),
    ("localhost:2,127.0.0.1:1", 3, False),
    ("localhost:4", 4, False)])
def test_ring_addresses_are_exported_as_the_jax_launcher_does(
        capsys, launcher, hosts, np_, hier):
    """The flat ring always (eager mode); the hierarchical pair only for
    several equal host groups: a ring inside each group, one of the
    groups' first ranks; every address a port of its own."""
    main = (tlaunch if launcher == "port" else jlaunch).main
    code = main(["-np", str(np_), "-H", hosts, sys.executable, "-c",
                 PRINT_RINGS])
    out = capsys.readouterr().out
    assert code == 0, out
    rings = _rings(out)
    assert sorted(rings) == list(range(np_))
    rows = [rings[r] for r in range(np_)]
    flat = {v["RING_ADDRS"] for v in rows}
    assert len(flat) == 1 and len(flat.pop().split(",")) == np_
    if not hier:
        assert all(v["LOCAL_RING_ADDRS"] is None
                   and v["CROSS_RING_ADDRS"] is None
                   for v in rows)
        return
    cross = {v["CROSS_RING_ADDRS"] for v in rows}
    assert len(cross) == 1
    cross = cross.pop().split(",")
    assert len(cross) == 2
    local = [rings[r]["LOCAL_RING_ADDRS"].split(",") for r in range(4)]
    assert local[0] == local[1] and local[2] == local[3]
    assert len(local[0]) == 2 and local[0] != local[2]
    ports = (rings[0]["RING_ADDRS"].split(",") + local[0] + local[2]
             + cross)
    assert len(set(ports)) == len(ports) == 10


def test_a_rank_failure_propagates_and_tears_the_job_down(capsys):
    script = ("import os, sys, time\n"
              "if os.environ['HOROVOD_RANK'] == '1':\n"
              "    sys.exit(3)\n"
              "time.sleep(60)\n")
    t0 = time.monotonic()
    code, _, err = _run(capsys, "-np", "2", sys.executable, "-c", script)
    assert code == 3
    assert "rank 1 exited with code 3; terminating remaining ranks" in err
    assert time.monotonic() - t0 < 30


def test_max_restarts_relaunches_with_the_epoch(capsys):
    script = ("import os, sys\n"
              "epoch = int(os.environ['HOROVOD_RESTART_EPOCH'])\n"
              "print('epoch', epoch)\n"
              "sys.exit(0 if epoch >= 1 else 5)\n")
    code, out, err = _run(capsys, "-np", "2", "--max-restarts", "2",
                          "--restart-backoff", "0", sys.executable, "-c",
                          script)
    assert code == 0
    assert "restarting (attempt 1/2)" in err
    assert "[0]: epoch 1" in out
    code, _, err = _run(capsys, "-np", "1", "--max-restarts", "1",
                        "--restart-backoff", "0", sys.executable, "-c",
                        "raise SystemExit(4)")
    assert code == 4 and "giving up after 1 restart(s)" in err


def test_version_flag(capsys):
    from horovod_tpu_torch import __version__

    with pytest.raises(SystemExit) as exit_:
        tlaunch.main(["-v"])
    assert exit_.value.code == 0
    assert capsys.readouterr().out.strip() == \
        f"horovod_tpu_torch v{__version__}"


@pytest.mark.parametrize("flag", [["--elastic"], ["--min-ranks", "2"],
                                  ["--max-ranks", "4"],
                                  ["--elastic-respawns", "1"],
                                  ["--trace", "/tmp/tr"]])
def test_later_slices_are_refused_by_name(capsys, monkeypatch, flag):
    # Elastic membership and cluster tracing have landed: their flags
    # reach the launch with the JAX launcher's meaning (their jobs:
    # tests/test_torch_elastic_mp.py, tests/test_torch_autotune_mp.py).
    seen = []
    monkeypatch.setattr(tlaunch, "run", lambda args: seen.append(args)
                        or 0)
    assert tlaunch.main(["-np", "2", *flag, sys.executable, "-c",
                         "pass"]) == 0
    value = getattr(seen[0], flag[0].lstrip("-").replace("-", "_"))
    if flag[0] == "--trace":
        assert value == flag[1]
    else:
        assert value == (True if len(flag) == 1 else int(flag[1]))
    assert seen[0].command == [sys.executable, "-c", "pass"]
    assert "not supported" not in capsys.readouterr().err


TIER = ("import torch, torch.distributed as dist\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.common import basics\n"
        "hvd.init(device='cpu')\n"
        "ctl = basics.controller()\n"
        "out = hvd.allreduce(torch.ones(3) * (hvd.rank() + 1))\n"
        "print('tier', 'controller' if ctl is not None else 'group',\n"
        "      dist.is_initialized(), out.tolist(),\n"
        "      ctl.counters()['tensors'] if ctl is not None else 0)\n"
        "hvd.shutdown()\n")


@pytest.mark.parametrize("spmd", [False, True])
def test_the_tier_follows_the_mode(spmd):
    # The Python controller on the TCP star (the native engine's tier is
    # held by tests/test_torch_native_engine.py).
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_CPU_OPS="star")
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR",
                "HOROVOD_SPMD_COORDINATOR", "HOROVOD_RENDEZVOUS_FILE"):
        env.pop(var, None)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
           *(["--spmd"] if spmd else []), sys.executable, "-c", TIER]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for rank in range(2):
        want = ("group True [1.5, 1.5, 1.5] 0" if spmd
                else "controller True [1.5, 1.5, 1.5] 1")
        assert f"[{rank}]: tier {want}" in proc.stdout, proc.stdout


def test_local_ports_are_drawn_below_the_ephemeral_range():
    """The launcher's ports (rendezvous, store, rings) come from below the
    kernel's ephemeral range, where no outgoing connection can take one
    before its rank binds it, and one launcher never gives a port twice."""
    floor = tlaunch._ephemeral_floor()
    ports = [tlaunch._free_port() for _ in range(64)]
    assert len(set(ports)) == len(ports)
    assert all(tlaunch._PORT_FLOOR <= p < floor for p in ports), ports
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        assert floor == int(f.read().split()[0])
