"""``--mesh host`` on the port's serve and replay CLIs, under a two-rank
gloo world on the CPU (``torchrun --standalone --nproc-per-node 2``).

Rank 0 alone prints the summary, whose ``mesh`` field is ``"host"`` as the
reference CLIs write it (``repro/launch/serve.py:379``,
``repro/launch/replay.py:182``), and ``--verify`` holds the sharded run to
the single-device static contiguous engine on the gathered weights.
Without a process group the flag raises, naming the ``torchrun`` command.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import replay as replay_cli
from repro_torch.launch import serve as serve_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--device", "cpu", "--mesh", "host", "--max-len", "32",
          "--prompt-len", "8", "--max-new", "4", "--block-size", "8",
          "--verify"]
RUNS = {
    "serve": ["repro_torch.launch.serve", "--engine", "continuous",
              "--cache", "paged", "--slots", "4", "--batch", "6"],
    "replay": ["repro_torch.launch.replay", "--cache", "contiguous",
               "--slots", "4", "--n", "6",
               "--faults", "slot_kill@2,device_fail@3:blocks=0:"
                           "restore_after=2"],
}


@pytest.fixture(scope="module")
def runs():
    """Both CLIs started together under torchrun; (rc, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", *argv, *COMMON],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, argv in RUNS.items()}
    out = {}
    for name, p in procs.items():
        try:
            o, e = p.communicate(timeout=240)
        finally:
            p.kill()
        out[name] = (p.returncode, o, e)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_host_under_torchrun(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, err[-3000:]
    assert out.count('"mesh"') == 1          # rank 0 alone prints
    record = json.loads(out[out.index("{"):])
    assert record["mesh"] == "host"
    assert record["verified"] is True
    assert record["device"] == "cpu"
    assert record["graphs"] == "eager"
    if name == "replay":
        kinds = [f["kind"] for f in record["faults"]]
        assert kinds[:2] == ["slot_kill", "device_fail"]


@pytest.mark.parametrize("cli", [serve_cli, replay_cli],
                         ids=["serve", "replay"])
def test_mesh_host_needs_a_process_group(cli, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        cli.main(["--device", "cpu", "--mesh", "host"])
    assert cli.build_parser().parse_args([]).mesh == "single"
