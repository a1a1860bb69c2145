"""The PyTorch port stands alone: it imports neither jax nor any module of
priblast_tpu, and its exact host engine reproduces the golden
predictions byte for byte."""

import subprocess
import sys

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None  # any `import jax` now raises ImportError


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "priblast_tpu" or name.startswith("priblast_tpu."):
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, sys.argv[1])

import priblast_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    priblast_tpu_torch.__path__, "priblast_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "priblast_tpu_torch.search.gapped" in names, names
bad = [m for m in sys.modules
       if m == "priblast_tpu" or m.startswith("priblast_tpu.")
       or m == "jax" or m.startswith("jax.")]
assert not [m for m in bad if sys.modules[m] is not None], bad

from priblast_tpu_torch.cli import main

main(["ris", "-i", sys.argv[2], "-o", sys.argv[3], "-d", sys.argv[4],
      "--engine", "exact"])
print("IMPORTED", len(names))
"""


def test_port_imports_alone_and_exact_engine_is_byte_identical(
        tmp_path, repo_root, data_dir, golden_dir):
    out = tmp_path / "exact.txt"
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, str(repo_root),
         str(data_dir / "tiny_q.fa"), str(out),
         str(golden_dir / "tiny" / "tiny_db")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "IMPORTED" in r.stdout
    body = out.read_text().splitlines()[2:]
    gold = (golden_dir / "tiny" / "predictions.txt").read_text() \
        .splitlines()[2:]
    assert body == gold


def test_port_sources_name_neither_jax_nor_the_jax_package(repo_root):
    files = sorted((repo_root / "priblast_tpu_torch").rglob("*.py"))
    files += sorted((repo_root / "priblast_tpu_torch").rglob("*.cu"))
    files.append(repo_root / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert "from jax" not in text, f
        assert "priblast_tpu." not in text, f
