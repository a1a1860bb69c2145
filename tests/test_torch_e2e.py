"""The port's entry points end to end on the tiny goldens, on the CPU:
`ris --engine gpu --device cpu` and `db --engine gpu --device cpu` held to
what tests/test_tpu_engine.py:55-109 holds the JAX device engine to, the
port's ris output also against JAX's own `--engine tpu` output, the
device engine's refusal to run without a card unless asked for the CPU,
and `--engine auto`: the default, the device engine, never the exact
engine."""

import filecmp

import numpy as np
import pytest
import torch

# the port runs many small tensor ops here: one intra-op thread per test
# worker avoids oversubscribing the host under pytest-xdist
torch.set_num_threads(1)

from priblast_tpu_torch import cli


def _ris(tmp_path, data_dir, golden_dir, *extra):
    out = str(tmp_path / "gpu.txt")
    cli.main(["ris", "-i", str(data_dir / "tiny_q.fa"), "-o", out, "-d",
              str(golden_dir / "tiny" / "tiny_db"), *extra])
    return open(out).read().splitlines()


def _same_hits(ref: list[str], got: list[str]) -> None:
    assert len(ref) == len(got)
    assert ref[0] == got[0] and ref[2] == got[2]  # headers
    # param header: identical except the db path spelling
    assert ([f for f in ref[1].split(",") if not f.startswith("database:")]
            == [f for f in got[1].split(",") if not f.startswith("database:")])
    for le, lt in zip(ref[3:], got[3:]):
        fe, ft = le.split(","), lt.split(",")
        # id, names, lengths, base pairs: exact
        assert fe[:5] == ft[:5] and fe[8:] == ft[8:], (le, lt)
        for a, b in zip(fe[5:8], ft[5:8]):  # energies: f32 engine noise
            assert abs(float(a) - float(b)) < 2e-3, (le, lt)


def test_ris_gpu_engine_on_cpu_matches_goldens_and_jax(tmp_path, data_dir,
                                                        golden_dir,
                                                        monkeypatch):
    from priblast_tpu.models import ris as jris
    from priblast_tpu.utils.params import RisParams as JRisParams

    # the device chain on both sides (the router's default, auto, sends
    # this tiny wave to the host chain)
    monkeypatch.setenv("PRIBLAST_DEVICE_EXTEND", "1")

    got = _ris(tmp_path, data_dir, golden_dir, "--device", "cpu")
    exact = (golden_dir / "tiny" / "predictions.txt").read_text() \
        .splitlines()
    _same_hits(exact, got)

    out_jax = str(tmp_path / "tpu.txt")
    jris.run(JRisParams(input=str(data_dir / "tiny_q.fa"), output=out_jax,
                        db_name=str(golden_dir / "tiny" / "tiny_db"),
                        algorithm="block", engine="tpu"))
    _same_hits(open(out_jax).read().splitlines(), got)


def _parse_acc(path, n_seqs):
    raw = open(path, "rb").read()
    off, out = 0, []
    for _ in range(2 * n_seqs):
        c = int(np.frombuffer(raw, np.int32, 1, off)[0])
        off += 4
        out.append(np.frombuffer(raw, np.float32, c, off))
        off += 4 * c
    assert off == len(raw)
    return out


def test_db_gpu_engine_on_cpu_matches_goldens(tmp_path, data_dir,
                                              golden_dir):
    db_name = str(tmp_path / "tiny_db")
    cli.main(["db", "-i", str(data_dir / "tiny_db.fa"), "-o", db_name,
              "--device", "cpu"])
    for ext in ("bas", "seq", "ind", "nam"):
        assert filecmp.cmp(f"{golden_dir}/tiny/tiny_db.{ext}",
                           f"{db_name}.{ext}", shallow=False)
    golden = _parse_acc(f"{golden_dir}/tiny/tiny_db.acc", 8)
    mine = _parse_acc(f"{db_name}.acc", 8)
    for ga, ma in zip(golden, mine):
        assert len(ga) == len(ma)
        assert np.abs(ga - ma).max() < 2e-3


@pytest.mark.parametrize("mode", ["ris", "db"])
def test_gpu_engine_without_a_card_raises(tmp_path, data_dir, golden_dir,
                                          mode):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if mode == "ris":
        argv = ["ris", "-i", str(data_dir / "tiny_q.fa"),
                "-o", str(tmp_path / "x.txt"),
                "-d", str(golden_dir / "tiny" / "tiny_db")]
    else:
        argv = ["db", "-i", str(data_dir / "tiny_db.fa"),
                "-o", str(tmp_path / "x")]
    with pytest.raises(RuntimeError, match="--device cpu") as err:
        cli.main(argv)
    assert "--engine exact" in str(err.value)
    assert not list(tmp_path.iterdir())   # nothing was written


def _argv(mode, tmp_path, data_dir, golden_dir, out):
    if mode == "ris":
        return ["ris", "-i", str(data_dir / "tiny_q.fa"), "-o",
                str(tmp_path / out), "-d",
                str(golden_dir / "tiny" / "tiny_db")]
    return ["db", "-i", str(data_dir / "tiny_db.fa"), "-o",
            str(tmp_path / out)]


@pytest.mark.parametrize("mode", ["ris", "db"])
def test_auto_engine_without_a_card_raises(tmp_path, data_dir, golden_dir,
                                           mode):
    """`--engine auto` without a card and without `--device cpu` fails as
    `--engine gpu` does, naming both ways out; it never falls to the
    exact engine."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = _argv(mode, tmp_path, data_dir, golden_dir, "x")
    with pytest.raises(RuntimeError, match="--engine exact") as err:
        cli.main(argv + ["--engine", "auto"])
    assert "--device cpu" in str(err.value)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("mode", ["ris", "db"])
def test_engine_flag_resolves_auto_to_the_device_engine(monkeypatch, mode,
                                                        tmp_path, data_dir,
                                                        golden_dir):
    """argparse takes auto, gpu and exact for both steps; the params the
    step receives hold gpu for auto and for no flag, and nothing else is
    accepted."""
    import importlib

    step = importlib.import_module(f"priblast_tpu_torch.models.{mode}")
    seen = []
    monkeypatch.setattr(step, "run", lambda p, **kw: seen.append(p.engine))
    argv = _argv(mode, tmp_path, data_dir, golden_dir, "x")
    for flag in ([], ["--engine", "auto"], ["--engine", "gpu"],
                 ["--engine", "exact"]):
        cli.main(argv + flag)
    assert seen == ["gpu", "gpu", "gpu", "exact"]
    with pytest.raises(SystemExit):
        cli.main(argv + ["--engine", "tpu"])


@pytest.mark.parametrize("mode", ["ris", "db"])
def test_auto_engine_on_cpu_writes_the_bytes_of_gpu(tmp_path, data_dir,
                                                    golden_dir, mode):
    """`--engine auto --device cpu` and `--engine gpu --device cpu` write
    the same bytes on the tiny goldens (every db file; the ris output)."""
    outs = {}
    for engine in ("auto", "gpu"):
        cli.main(_argv(mode, tmp_path, data_dir, golden_dir, engine)
                 + ["--engine", engine, "--device", "cpu"])
        outs[engine] = sorted(tmp_path.glob(f"{engine}*"))
    assert outs["auto"] and len(outs["auto"]) == len(outs["gpu"])
    for a, b in zip(outs["auto"], outs["gpu"]):
        assert a.suffix == b.suffix
        assert a.read_bytes() == b.read_bytes(), a
