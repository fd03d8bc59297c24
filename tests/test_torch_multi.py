"""The port's multi-card smoke run (``chip_smoke_multi.py``) on gloo ranks.

``chip_smoke_multi.py --device cpu --size small`` runs every phase of the
multi-card run in 2 and in 4 processes on the CPU (a few iterations,
2 x 32 x 48 x 3 scenes, 16^2 training crops): the tiled solvers on
``{"tile": 2}`` (a sub-mesh of the 4-rank world), ``{"tile": N}`` and
``{"data": 2, "tile": N/2}`` against the one-process solvers, kernel Q2-4's
plain twin on the halo rows the exchange delivered against Q2-1's twin on
the whole stack, data-parallel training against the one-process trainer on
the global batch, and the train CLI across the ranks.  The script checks
each result itself and fails on a miss; these tests read its summary line
and hold the numbers to the bounds below.  Its launcher is also driven on
small scripts whose ranks raise or hang.

Tolerances: tiled x against the one-process solve within 1e-4 (1e-3 for
Anderson; bf16 state within twice the one-process bf16-against-fp32 gap
plus 1e-3), as the on-card run holds them; data-parallel parameters after 3
steps within 1e-6 of the one-process trainer (mse, AdaBelief lr 0.1), on
the global batch and on the mean of the shards' gradients alike, as
``tests/test_torch_data_parallel.py`` holds 2 ranks; the all-reduced step-1
gradient within 1e-6 of the largest entry.  Every spawn has its own kill
timeout of 240 s.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPAWN_TIMEOUT = 240
sys.path.insert(0, REPO)

import chip_smoke_multi as multi  # noqa: E402


def _run(args, timeout=SPAWN_TIMEOUT):
    """Run the launcher in its own session, so that a hung run is killed
    with every rank it started."""
    env = {**os.environ, "PYTHONPATH": "", "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke_multi.py"), *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def run(request):
    world = request.param
    code, out = _run(["--device", "cpu", "--size", "small", "--world", str(world),
                      "--deadline", "200"])
    assert code == 0, out[-6000:]
    lines = out.splitlines()
    summary = json.loads(next(ln for ln in lines if ln.startswith("[summary] {"))[10:])
    return world, summary, lines


def test_every_phase_ran_and_the_last_line_is_the_result(run):
    world, summary, lines = run
    assert json.loads(lines[-1]) == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                                            "count": world}}
    assert summary["world"] == world and set("ABCDEFG") <= set(summary)
    assert summary["A"]["members"][f"tile{world}"] == [True] * world


def test_tiled_solvers_match_the_one_process_solvers(run):
    world, summary, _ = run
    rows = [r for r in summary["C"] if "solver" in r]
    meshes = set(multi.mesh_axes(world))
    assert {r["mesh"] for r in rows} == meshes
    assert len(rows) == len(meshes) * 2 * len(multi.solver_cases(multi.SIZES["small"]))
    for r in rows + [r for r in summary["B"].values() if "dx" in r]:
        assert r["same_bits"] and r["dx"] <= r["tol"], r
        if "iterations" in r:
            assert r["iterations"][0] == r["iterations"][1] and r["rho_equal"], r
        bound = 1e-3 if "anderson" in r.get("solver", "anderson") else 1e-4
        if r.get("solver") != "bf16":
            assert r["tol"] <= bound, r
    assert all(r["box"][0] >= 0.0 and r["box"][1] <= 1.0 for r in rows if "box" in r)


def test_ranks_outside_a_mesh_make_it_and_skip_its_solves(run):
    """Every rank makes every mesh; a mesh takes the first ranks, and a
    rank outside it (ranks 2 and 3 of ``{"tile": 2}`` in a world of 4) runs
    none of its solves and hangs no other rank."""
    world, summary, _ = run
    for name, axes in multi.mesh_axes(world).items():
        size = 1
        for v in axes.values():
            size *= v
        members = summary["A"]["members"][name]
        assert members == [r < size for r in range(world)], name
        for r in summary["C"]:
            if r.get("mesh") == name and "solver" in r:
                assert [v is None for v in r["it_s_by_rank"]] == [not m for m in members], r
        for r in summary["D"]:
            if r["mesh"] == name:
                assert len(r["ms_by_rank"]) == size
    if world == 4:
        assert summary["A"]["members"]["tile2"] == [True, True, False, False]


def test_halo_rows_from_the_exchange_hold_q2_4_and_q2_1(run):
    world, summary, lines = run
    rows = summary["D"]
    assert len(rows) == len(multi.mesh_axes(world)) * 2 * 2
    held = [ln for ln in lines if ln.startswith("[D ") and "bit for bit" in ln]
    assert len(held) == len(rows)


def test_data_parallel_equals_the_one_process_global_step(run):
    world, summary, _ = run
    f = summary["F"]
    assert f["global_batch"] == 2 * world and f["same_bits_each_step"] == [True] * 3
    for suffix in ("", "_global"):  # the shard means, and the global batch at once
        assert f[f"grad_rel{suffix}"] <= 1e-6
        assert f[f"params{suffix}"]["max_abs"] <= 1e-6 and f[f"params{suffix}"]["strict"]


def test_train_cli_writes_from_rank_0_only(run):
    world, summary, _ = run
    g = summary["G"]
    assert g["printed_lines_by_rank"][0] > 0 and g["printed_lines_by_rank"][1:] == [0] * (world - 1)
    lead = g["files_by_rank"][0]
    assert "train_eval_metrics_history.csv" in lead and "checkpoints/epoch_0.pt" in lead
    assert g["files_by_rank"][1:] == [[]] * (world - 1)
    assert len(g["means"]) == 2  # the train and the eval means of the one epoch


@pytest.mark.parametrize("size, world", [("full", 4), ("full", 2), ("cut", 1)])
def test_every_stack_a_card_run_hands_a_kernel_is_checked(size, world):
    """The 4-card run and chip_smoke.py's one-card phase hand each kernel
    only plane stacks at which chip_smoke.py holds it against its plain twin
    (the launcher refuses a run that would not)."""
    assert multi.unchecked_stacks(multi.SIZES[size], world) == {}
    stacks = multi.kernel_stacks(multi.SIZES[size], world)
    assert (12, 1080, 1920) in stacks["fwd"] and (30, 256, 256) in stacks["bwd"]


def test_the_small_size_is_for_the_cpu_only():
    """The small size's stacks are not checked on the card: the launcher
    refuses it there."""
    unchecked = multi.unchecked_stacks(multi.SIZES["small"], 1)
    assert (6, 16, 16) in unchecked["bwd"] and (6, 32, 48) in unchecked["halo"]


# Rank 1 acts before it joins the group, so the other ranks wait for it in
# the rendezvous, which a peer that never comes does not end: waiting in a
# collective, gloo may end them itself before the launcher sees rank 1 exit,
# and the launcher then rightly names them as failed too.
_RANK_SCRIPT = """
import os, sys, time
sys.path.insert(0, {repo!r})
if os.environ["RANK"] == "1":
    {action}
import torch, torch.distributed as dist
from admm_deconv_tpu_torch.parallel import distributed
distributed.initialize(device_type="cpu")  # the other ranks wait for rank 1 here
dist.all_reduce(torch.ones(1))
"""


@pytest.mark.parametrize("action, deadline, named", [
    # A rank that raises ends the run at once, long before the deadline
    # (which only has to outlast the ranks' start on a loaded host).
    ("raise RuntimeError('rank 1 raises')", 150, "rank 1 failed (exit code 1)"),
    ("time.sleep(600)", 8, "rank 1 still running at the 8 s deadline: killed"),
])
def test_launcher_ends_the_run_and_names_the_rank(tmp_path, capsys, action, deadline, named):
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(_RANK_SCRIPT.format(repo=REPO, action=action)))
    t0 = time.monotonic()
    code, held = multi.launch([sys.executable, str(script)], 3, deadline, str(tmp_path), "cpu")
    out = capsys.readouterr().out
    assert code == 1 and held is None
    assert time.monotonic() - t0 < deadline + 30
    assert named in out, out
    if "raise" in action:
        assert "RuntimeError: rank 1 raises" in out
        assert "rank 0 killed after rank 1 failed" in out
        assert "rank 2 killed after rank 1 failed" in out


def test_refuses_without_a_card():
    code, out = _run(["--world", "1"], timeout=120)
    assert code not in (0, None)
    assert '"ok"' not in out


def test_refuses_outside_a_checkout(tmp_path):
    (tmp_path / "chip_smoke_multi.py").write_bytes(
        open(os.path.join(REPO, "chip_smoke_multi.py"), "rb").read())
    proc = subprocess.run([sys.executable, "chip_smoke_multi.py", "--device", "cpu", "--world", "1",
                           "--size", "small"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
