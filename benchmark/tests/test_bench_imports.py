"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the port. Top-level module names are
compared whole: `priblast_tpu_torch` is not `priblast_tpu`."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "priblast_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.name))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & JAX_SIDE


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=lambda p: str(p.name))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert not names & (JAX_SIDE | {"priblast_tpu_torch", "pbench",
                                    "torch"})


def test_whole_names_are_compared():
    assert "priblast_tpu_torch".split(".")[0] not in JAX_SIDE
    assert "priblast_tpu.ops".split(".")[0] in JAX_SIDE


def test_reference_runs_with_the_port_and_jax_blocked():
    """The reference in a fresh process where importing the port, JAX or
    the JAX package raises."""
    blocked = sorted(JAX_SIDE | {"priblast_tpu_torch"})
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {blocked!r}:
                    raise ImportError("blocked " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(BENCH)!r})
        from reference import jobs, index
        acc = jobs.accessibility(("GGGAAACCCUUUGGGCCCAAAUUU" * 3, 70, 5))
        hits = jobs.search_pair(("GGGCCCAAAUUUGGG" * 4, "CCCGGGUUUAAACCC" * 4,
                                 acc, acc, dict(max_seed_length=20,
                                 hybrid_thr=-6.0, min_acc_len=5,
                                 interaction_thr=-4.0, final_thr=-8.0,
                                 dropout_wo_gap=5, dropout_w_gap=16,
                                 min_helix=3)))
        enc = index.encode_page(["ACGU", "GGA"])
        index.kmer_hash(enc, index.suffix_array(enc), 2)
        bad = sorted({{m.split(".")[0] for m in sys.modules}} &
                     set({blocked!r}))
        print("BAD", bad)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout


def test_forbidden_modules_names_them(monkeypatch):
    """The run's own check names a forbidden module by its whole top-level
    name, and takes the port for none."""
    from pbench import main

    assert set(main.FORBIDDEN) == JAX_SIDE
    for name in list(sys.modules):
        if name.split(".")[0] in JAX_SIDE:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "priblast_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "priblast_tpu_torch.y", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "priblast_tpu.z", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert main.forbidden_modules() == ["jax", "priblast_tpu"]
