"""The port stands alone: no module of ``multimodal_idbn_tpu_torch`` and
nothing in ``chip_smoke.py`` imports JAX, the JAX package or the JAX
package's ``benchmarks`` (the quality protocol reads their JSON only), the port
imports and runs with both blocked, and ``chip_smoke.py`` fails without a
GPU and without the package beside it. The card's installation has no
matplotlib, pandas or wandb: no port module imports them when it is
imported, and the port imports, trains and logs its diagnostics with the
three blocked."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multimodal_idbn_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "multimodal_idbn_tpu", "benchmarks"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    assert len(_sources()) > 15
    for path in _sources():
        bad = FORBIDDEN & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
BLOCK = {"jax", "jaxlib", "multimodal_idbn_tpu", "benchmarks"}
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Blocker())
import multimodal_idbn_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import torch
from multimodal_idbn_tpu_torch.models import RBM
rbm = RBM(6, 4, 0.1, 1e-4, 0.5, device="cpu")
rbm.train_epoch(torch.ones(3, 6), 0, 1, CD=1)
from multimodal_idbn_tpu_torch import quality
assert len(quality.recorded_arms("flagship")["jax"]) == 26
quality.compare([0.1, 0.2, 0.3], [0.2, 0.3, 0.4])
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print("ok", len(names))
"""


def test_port_imports_and_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_fails_without_gpu(tmp_path):
    """No visible GPU: non-zero exit and no result, both from the checkout
    and from a directory that holds chip_smoke.py alone."""
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_bimodal_slice_modules_are_covered():
    """The bimodal slice's modules are among the sources checked above
    and are walked by the blocked import."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"ops/bimodal_ops.py", "models/imdbn_bimodal.py",
            "train_bimodal.py", "cuts.py", "ops/half_step.py"} <= names
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.replace(
            'print("ok", len(names))',
            'assert "multimodal_idbn_tpu_torch.train_bimodal" in names\n'
            'print("ok", len(names))')],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serving_slice_modules_are_covered(tmp_path):
    """The modules of the save / load / resume / serve slice are among the
    sources checked above and are walked by the blocked import."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"checkpoint/__init__.py", "checkpoint/reference_pickle.py",
            "generate.py", "convert.py", "models/rbm.py", "models/idbn.py",
            "models/imdbn.py", "ops/schedules.py"} <= names
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.replace(
            'print("ok", len(names))',
            'for n in ("checkpoint", "checkpoint.reference_pickle", '
            '"generate"):\n'
            '    assert "multimodal_idbn_tpu_torch." + n in names, n\n'
            'import pickle\n'
            'from multimodal_idbn_tpu_torch import checkpoint\n'
            'r2 = pickle.loads(pickle.dumps(rbm))\n'
            f'checkpoint.save_checkpoint(r2, {str(tmp_path / "r")!r})\n'
            'assert not [m for m in sys.modules '
            'if m.split(".")[0] in BLOCK]\n'
            'print("ok", len(names))')],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_parallel_modules_are_covered():
    """The parallel/ package and the batch shard are among the sources
    checked above, and with JAX blocked a mesh of this process trains."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"parallel/__init__.py", "parallel/distributed.py",
            "parallel/data_parallel.py", "parallel/mesh2d.py",
            "ops/shard.py"} <= names
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.replace(
            'print("ok", len(names))',
            'from multimodal_idbn_tpu_torch import parallel\n'
            'from multimodal_idbn_tpu_torch.ops import rbm_ops\n'
            'mesh = parallel.make_mesh(1, device="cpu")\n'
            'st, loss = parallel.dp_cd_update(mesh, rbm.state, 1, '
            'torch.ones(3, 6), lr=0.1, mom=0.5, weight_decay=0.0, cd=1)\n'
            'parallel.tp_cd_update(parallel.make_mesh_2d(dp=1, mp=1, '
            'device="cpu"), st, '
            '2, torch.ones(3, 6), lr=0.1, mom=0.5, weight_decay=0.0, '
            'cd=1)\n'
            'assert not [m for m in sys.modules '
            'if m.split(".")[0] in BLOCK]\n'
            'print("ok", len(names))')],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("entry", ["profile_main_path", "bench_kernels",
                                   "generate", "cuts"])
def test_entry_points_refuse_to_run_without_a_gpu(entry, monkeypatch,
                                                  tmp_path):
    """The measuring and serving entry points run on the card only (or,
    for ``generate``, on the CPU when asked): with no GPU they raise and
    do not drift to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    import importlib
    mod = importlib.import_module(f"multimodal_idbn_tpu_torch.{entry}")
    monkeypatch.setattr(sys, "argv", [entry])
    with pytest.raises(RuntimeError, match="CUDA device"):
        if entry == "generate":
            mod.main(["--model", "absent.pkl", "--labels", "0"])
        elif entry == "cuts":
            mod.run_cut("flagship-cut", tmp_path)
        else:
            mod.main()


OPTIONAL = {"matplotlib", "pandas", "wandb", "mpl_toolkits"}


def _top_level_imports(path: Path):
    """Roots imported while the module is imported: everywhere but inside
    functions, which run later."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0]
            else:
                yield from walk(child)
    yield from walk(ast.parse(path.read_text(), filename=str(path)))


def test_port_imports_no_optional_package_at_import_time():
    for path in sorted(PORT.rglob("*.py")):
        bad = OPTIONAL & set(_top_level_imports(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_BLOCKED_OPTIONAL = _BLOCKED_IMPORT.replace(
    'BLOCK = {"jax", "jaxlib", "multimodal_idbn_tpu", "benchmarks"}',
    'BLOCK = {"jax", "jaxlib", "multimodal_idbn_tpu", "matplotlib", '
    '"pandas", "wandb", "mpl_toolkits"}').replace(
    'print("ok", len(names))', r"""
from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
from multimodal_idbn_tpu_torch.models import iMDBN
from multimodal_idbn_tpu_torch.utils.wandb_compat import RecorderRun, wandb
assert wandb.init() is None and wandb.run is None      # the stub
train, val, _ = create_dataloaders_uniform(batch_size=16, n_samples=48,
                                           num_classes=4, side=12, seed=0)
params = {"LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4,
          "INIT_MOMENTUM": 0.5, "FINAL_MOMENTUM": 0.9,
          "LEARNING_RATE_DYNAMIC": True, "CD": 1, "CROSS_GIBBS_STEPS": 3,
          "JOINT_AUX_COND_STEPS": 2}
run = RecorderRun()
cfg = {s: {"enable": True} for s in ("energy", "trajectory", "neighbors",
                                      "convergence")}
cfg["convergence"]["num_steps"] = 4
cfg["trajectory"]["num_samples"] = 1
m = iMDBN([144, 16, 8], 6, params=params, dataloader=train, val_loader=val,
          device="cpu", num_labels=4, seed=0, wandb_run=run, logging_cfg=cfg)
m.image_idbn.arch_dir = sys.argv[1]
m.image_idbn.train(1, log_every_pca=1, log_every_probe=1)
m.train_joint(1, log_every_pca=1, log_every_probe=1, log_every=1)
keys = run.keys()
warns = {k for k in keys if k.startswith("warn/")} - {"warn/idbn_blank_recon"}
assert warns and all(k.endswith("_figure_skipped") for k in warns), warns
for k in ("probe/layer2/labels/acc", "probe/joint/labels/acc",
          "embeddings/val/Joint_top/pca_2d_correlations", "snap/image_mse",
          "case/fixed/summary", "conv/panel/panel/summary",
          "zcheck/z_check/cosine_mean", "auto_recon/text_top1",
          "probe/joint/labels/confusion_table", "vecdb/knn_zT"):
    assert k in keys, k
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print("ok", len(names))""")


def test_port_trains_and_logs_without_optional_packages(tmp_path):
    out = subprocess.run([sys.executable, "-c", _BLOCKED_OPTIONAL,
                          str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("ok")


def test_variants_and_data_slice_modules_are_covered():
    """The modules of the variants and data-backends slice are among the
    sources checked above and walked by the blocked import; the native
    generator builds from the port's own source into the port's _build/
    and the JAX package's library is never loaded."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"data/native/__init__.py", "data/numerosity.py",
            "data/__init__.py", "ops/fast_cd.py", "ops/dbn_train.py",
            "device.py"} <= names
    assert (PORT / "data" / "native" / "dotgen.cpp").is_file()
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.replace(
            'print("ok", len(names))',
            'assert "multimodal_idbn_tpu_torch.data.native" in names\n'
            'from multimodal_idbn_tpu_torch import set_global_seed\n'
            'from multimodal_idbn_tpu_torch.data import native, '
            'create_dataloaders_zipfian\n'
            'assert native.native_available()\n'
            'tr, _, _ = create_dataloaders_zipfian(batch_size=4, '
            'n_samples=12, num_classes=3, side=16)\n'
            'lib = native._lib._name\n'
            'assert "/multimodal_idbn_tpu_torch/_build/dotgen-" in lib, lib\n'
            'maps = open("/proc/self/maps").read()\n'
            'assert "_dotgen.so" not in maps\n'
            'assert not [m for m in sys.modules '
            'if m.split(".")[0] in BLOCK]\n'
            'print("ok", len(names))')],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
