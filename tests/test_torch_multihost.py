"""Several processes of the port (parallel/multihost.py, torch.distributed
with gloo), as two local processes on the CPU: the analog of the
reference's `mpirun -np 2` runs. The shards are the JAX package's, index
for index; outputs are byte-identical to one process's, because process 0
merges the part files in global order (tests/test_multihost.py holds the
JAX package to the same)."""

import filecmp
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from priblast_tpu.parallel import multihost as jmh
from priblast_tpu.utils import fasta as jfasta
from priblast_tpu_torch.parallel import multihost as mh
from priblast_tpu_torch.utils import fasta

_TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", PRIBLAST_DIST_TIMEOUT="120")
    env.update(extra)
    return env


def _run(args, repo, env):
    r = subprocess.run([sys.executable, "-m", "priblast_tpu_torch"] + args,
                       env=env, cwd=repo, capture_output=True, text=True,
                       timeout=_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]


def _run_all(args, nprocs: int, repo, **extra):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "priblast_tpu_torch"] + args,
        env=_env(PRIBLAST_NUM_PROCS=str(nprocs), PRIBLAST_PROC_ID=str(i),
                 PRIBLAST_COORD=f"localhost:{port}", **extra),
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(nprocs)]
    try:
        for proc in procs:
            _out, err = proc.communicate(timeout=_TIMEOUT_S)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# ---- shards and part files ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_partitions_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(0, 80))
        # repeated lengths test the tie order
        lengths = [int(x) for x in rng.choice(
            [int(rng.integers(1, 5000)), 100, 100, 7], n)]
        parts = int(rng.integers(1, 9))
        assert (fasta.partition_block(n, parts)
                == jfasta.partition_block(n, parts))
        assert (fasta.partition_lpt(lengths, parts)
                == jfasta.partition_lpt(lengths, parts))
        assert (fasta.partition_area(lengths, parts)
                == jfasta.partition_area(lengths, parts))
        for algorithm in ("block", "heap", "area", "dynamic"):
            assert (mh.partition_for(algorithm, lengths, parts)
                    == jmh.partition_for(algorithm, lengths, parts))
        seqs = ["A" * x for x in lengths]
        assert (fasta.sort_indices_by_length_desc(seqs)
                == jfasta.sort_indices_by_length_desc(seqs))


def test_part_files_round_trip_and_read_the_jax_format(tmp_path):
    results = {3: ["a,b", "c"], 0: [], 7: ["x"]}
    mh.write_ris_part(tmp_path / "r0", results)
    jmh.write_ris_part(tmp_path / "r1", {1: ["j"]})
    assert mh.read_ris_parts([tmp_path / "r0", tmp_path / "r1"]) == {
        **results, 1: ["j"]}
    jmh.write_ris_part(tmp_path / "rj", results)
    assert (tmp_path / "r0").read_bytes() == (tmp_path / "rj").read_bytes()

    rng = np.random.default_rng(0)
    accs = {i: rng.random(10 + i).astype(np.float32) for i in (0, 2)}
    conds = {i: rng.random(12 + i).astype(np.float32) for i in (0, 2)}
    mh.write_acc_part(tmp_path / "a0", accs, conds)
    mh.write_acc_part(tmp_path / "a1", {1: accs[0][:4]}, {1: conds[0][:5]})
    got_a, got_c = mh.read_acc_parts([tmp_path / "a0", tmp_path / "a1"], 3)
    want_a, want_c = {**accs, 1: accs[0][:4]}, {**conds, 1: conds[0][:5]}
    for i in range(3):
        assert got_a[i].dtype == got_c[i].dtype == np.float32
        assert np.array_equal(got_a[i], want_a[i])
        assert np.array_equal(got_c[i], want_c[i])
    jmh.write_acc_part(tmp_path / "aj", accs, conds)
    ja, jc = mh.read_acc_parts([tmp_path / "aj"], 3)
    assert ja[1] is None and jc[1] is None
    assert all(np.array_equal(ja[i], accs[i]) and np.array_equal(jc[i],
                                                                  conds[i])
               for i in (0, 2))


def test_part_path_goes_under_tmp_path_or_beside_the_output(tmp_path):
    out = str(tmp_path / "o" / "pred.txt")
    assert mh.part_path(out, "", 1) == tmp_path / "o" / "pred.txt.part1"
    assert (mh.part_path(out, str(tmp_path / "t"), 0)
            == tmp_path / "t" / "pred.txt.part0")
    assert (tmp_path / "t").is_dir()


def test_one_process_needs_no_group(monkeypatch):
    monkeypatch.delenv("PRIBLAST_NUM_PROCS", raising=False)
    assert mh.init_from_env() == (0, 1)
    mh.shutdown()


# ---- two processes -------------------------------------------------------

def test_two_processes_exact_ris_matches_golden(tmp_path, data_dir,
                                                golden_dir, repo_root):
    out = tmp_path / "mp.txt"
    _run_all(["ris", "-i", str(data_dir / "tiny_q.fa"), "-o", str(out),
              "-d", str(golden_dir / "tiny" / "tiny_db"),
              "--engine", "exact", "-a", "area", "-p", str(tmp_path / "p")],
             2, str(repo_root))
    got = out.read_text().splitlines()
    want = (golden_dir / "tiny" / "predictions.txt").read_text().splitlines()
    assert got[2:] == want[2:]  # body byte-identical; header paths differ
    assert not list((tmp_path / "p").iterdir())  # the parts are removed


def test_two_processes_exact_db_matches_golden(tmp_path, data_dir,
                                               golden_dir, repo_root):
    db = tmp_path / "tiny_db"
    _run_all(["db", "-i", str(data_dir / "tiny_db.fa"), "-o", str(db),
              "--engine", "exact", "-a", "block"], 2, str(repo_root))
    for ext in ("bas", "seq", "ind", "nam", "acc"):
        assert filecmp.cmp(str(golden_dir / "tiny" / f"tiny_db.{ext}"),
                           f"{db}.{ext}", shallow=False), ext
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"tiny_db.{ext}" for ext in ("acc", "bas", "ind", "nam", "seq")]


def test_two_processes_gpu_ris_on_cpu_match_one(tmp_path, data_dir,
                                                golden_dir, repo_root):
    """The device chain in two processes: each process's accessibility
    batches hold other sequences than one process's, and the per-sequence
    DP does not depend on its batch-mates, so the bodies are the same
    bytes."""
    args = ["ris", "-i", str(data_dir / "tiny_q.fa"),
            "-d", str(golden_dir / "tiny" / "tiny_db"), "--device", "cpu",
            "-a", "area", "-p", str(tmp_path)]
    single = tmp_path / "sp.txt"
    _run(args + ["-o", str(single)], str(repo_root),
         _env(PRIBLAST_DEVICE_EXTEND="1"))
    out = tmp_path / "mp.txt"
    _run_all(args + ["-o", str(out)], 2, str(repo_root),
             PRIBLAST_DEVICE_EXTEND="1")
    assert out.read_text().splitlines()[2:] == \
        single.read_text().splitlines()[2:]


def test_two_processes_gpu_db_on_cpu_match_one(tmp_path, data_dir,
                                               repo_root):
    args = ["db", "-i", str(data_dir / "tiny_db.fa"), "--device", "cpu",
            "-a", "block"]
    _run(args + ["-o", str(tmp_path / "sp")], str(repo_root), _env())
    _run_all(args + ["-o", str(tmp_path / "mp")], 2, str(repo_root))
    for ext in ("bas", "seq", "ind", "nam", "acc"):
        assert filecmp.cmp(f"{tmp_path}/sp.{ext}", f"{tmp_path}/mp.{ext}",
                           shallow=False), ext


def test_a_lost_peer_ends_the_run(tmp_path, data_dir, golden_dir,
                                  repo_root):
    """Process 1 of 2 alone: the rendezvous times out and the run fails,
    rather than waiting for a peer that never comes."""
    r = subprocess.run(
        [sys.executable, "-m", "priblast_tpu_torch", "ris",
         "-i", str(data_dir / "tiny_q.fa"), "-o", str(tmp_path / "x.txt"),
         "-d", str(golden_dir / "tiny" / "tiny_db"), "--engine", "exact"],
        env=_env(PRIBLAST_NUM_PROCS="2", PRIBLAST_PROC_ID="1",
                 PRIBLAST_COORD=f"localhost:{_free_port()}",
                 PRIBLAST_DIST_TIMEOUT="5"),
        cwd=str(repo_root), capture_output=True, text=True,
        timeout=_TIMEOUT_S)
    assert r.returncode != 0
    assert not (tmp_path / "x.txt").exists()
