"""The port does everything the JAX package does: every public module,
function, class and method of ``multimodal_idbn_tpu`` (read from its
sources' ASTs) has a counterpart of the same name in
``multimodal_idbn_tpu_torch`` whose parameter names include the JAX
one's. The exceptions are listed below, each with its reason; a listed
exception that is no longer needed fails the test too, so the list stays
true.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "multimodal_idbn_tpu"

# JAX module -> the port's module of the same job under another name.
RENAMED = {
    "ops/pallas_cd.py": "ops/fast_cd.py",
    "ops/pallas_chain.py": "ops/chain.py",
    "ops/pallas_kernels.py": "ops/half_step.py",
}

_TPU = "a TPU/XLA switch: the port always runs its CUDA kernels on the card"
_NO_LIMIT = ("the CUDA kernels take every shape, so no dispatcher asks "
             "whether one is supported")
_TILES = ("TPU block sizes: the port's kernels choose their tiling from the "
          "shape (half_step.plan)")
_AXIS = ("the port's meshes have one data axis, which the mesh names; no "
         "axis name is passed")

# "module:name" or "module:name(param)" -> why the port has none.
EXCEPTIONS = {
    "config.py": "the JAX runtime switches; the port's counterpart of "
                 "set_matmul_precision is device.set_matmul_precision",
    "config.py:enable_pallas_chain": _TPU,
    "config.py:pallas_chain_enabled": _TPU,
    "config.py:enable_pallas_cd": _TPU,
    "config.py:pallas_cd_enabled": _TPU,
    "config.py:set_matmul_precision": "device.set_matmul_precision",
    "config.py:enable_persistent_compilation_cache":
        "XLA's compilation cache; the port builds its kernels once per "
        "source hash into _build/",
    "checkpoint/__init__.py:save_checkpoint_orbax":
        "needs orbax; the port's counterpart is save_checkpoint_torch",
    "checkpoint/__init__.py:load_checkpoint_orbax":
        "needs orbax; the port's counterpart is load_checkpoint_torch",
    "models/rbm.py:as_array": "device.as_tensor, which also places the "
                              "tensor on the model's device",
    "models/rbm.py:RBM.state": "an instance attribute of the port's RBM, "
                               "a property of JAX's",
    "models/idbn.py:iDBN.__init__(logging_config_path)":
        "read into logging_cfg, which JAX's iDBN never uses",
    "models/imdbn.py:iMDBN.__init__(layer_sizes_txt_or_joint)":
        "the reference's legacy constructor with a text DBN; the port "
        "takes the joint width as the second argument",
    "models/imdbn.py:iMDBN.__init__(text_posenc_dim)":
        "ignored by JAX too (imdbn.py:67)",
    "models/imdbn.py:iMDBN.__init__(embedding_dim)":
        "ignored by JAX too (imdbn.py:67)",
    "ops/dbn_train.py:idbn_epoch(shard_axis)": _AXIS,
    "ops/dbn_train.py:idbn_epoch_block(shard_axis)": _AXIS,
    "ops/imdbn_ops.py:joint_epoch(shard_axis)": _AXIS,
    "ops/imdbn_ops.py:joint_epoch_block(shard_axis)": _AXIS,
    "ops/bimodal_ops.py:bimodal_joint_epoch(shard_axis)": _AXIS,
    "ops/bimodal_ops.py:bimodal_epoch_block(shard_axis)": _AXIS,
    "ops/pallas_chain.py:chain_kernel_supported": _NO_LIMIT,
    "ops/pallas_chain.py:conditional_gibbs_fast":
        "rbm_ops.conditional_gibbs runs the chain kernel on the card",
    "ops/pallas_chain.py:noisy_meanfield_fast":
        "rbm_ops.noisy_meanfield_annealed runs the chain kernel on the card",
    "ops/pallas_chain.py:conditional_gibbs_reference": "chain.chain_plain",
    "ops/pallas_kernels.py:pallas_supported": _NO_LIMIT,
    "ops/pallas_kernels.py:sampled_cd_supported": _NO_LIMIT,
    "ops/pallas_kernels.py:hidden_probs_pallas":
        "half_step.hidden_probs_kernel",
    "ops/pallas_kernels.py:reference_half_step":
        "half_step.half_step_probs_plain",
    "ops/pallas_kernels.py:half_step_sample_aligned":
        "half_step.half_step_sample, which takes any shape unpadded",
    "ops/pallas_kernels.py:half_step_sample(v)":
        "JAX's half_step_sample is the port's half_step_sample_resident; "
        "the port's half_step_sample is JAX's half_step_sample_aligned",
    "ops/pallas_kernels.py:half_step_sample(block_m)": _TILES,
    "ops/pallas_kernels.py:half_step_sample(block_n)": _TILES,
    "ops/pallas_kernels.py:half_step_probs(block_m)": _TILES,
    "ops/pallas_kernels.py:half_step_probs(block_n)": _TILES,
    "ops/pallas_kernels.py:half_step_sample_big(block_m)": _TILES,
    "ops/pallas_kernels.py:half_step_sample_big(block_n)": _TILES,
    "ops/pallas_kernels.py:half_step_sample_big(block_k)": _TILES,
}


def _params(fn_node):
    a = fn_node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _jax_surface():
    """[(module path, name, JAX parameter names or None, class name)] of
    every public module-level function and class and every public method
    (and ``__init__``) of a public class."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        out.append((rel, None, None, None))
        for node in ast.parse(path.read_text()).body:
            if node.name.startswith("_") if hasattr(node, "name") else True:
                continue
            if isinstance(node, ast.FunctionDef):
                out.append((rel, node.name, _params(node), None))
            elif isinstance(node, ast.ClassDef):
                out.append((rel, node.name, None, None))
                for m in node.body:
                    if isinstance(m, ast.FunctionDef) and (
                            not m.name.startswith("_")
                            or m.name == "__init__"):
                        out.append((rel, m.name, _params(m), node.name))
    return out


def _port_module(rel):
    rel = RENAMED.get(rel, rel)
    name = rel[:-3].replace("/", ".")
    if name.endswith(".__init__"):
        name = name[:-len(".__init__")]
    if name == "__init__":
        return importlib.import_module("multimodal_idbn_tpu_torch")
    try:
        return importlib.import_module(f"multimodal_idbn_tpu_torch.{name}")
    except ModuleNotFoundError:
        return None


def _port_params(obj):
    if isinstance(obj, property):
        return None
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _gaps():
    gaps = set()
    for rel, name, params, cls in _jax_surface():
        mod = _port_module(rel)
        if name is None:
            if mod is None:
                gaps.add(rel)
            continue
        if mod is None:
            gaps.add(f"{rel}:{name}")
            continue
        owner = getattr(mod, cls, None) if cls else mod
        label = f"{rel}:{cls}.{name}" if cls else f"{rel}:{name}"
        if owner is None or not hasattr(owner, name):
            gaps.add(label)
            continue
        have = _port_params(inspect.getattr_static(owner, name)
                            if cls else getattr(owner, name))
        if params is None or have is None:
            continue
        gaps.update(f"{label}({p})" for p in params if p not in have)
    return gaps


def test_every_jax_name_has_a_port_counterpart():
    gaps = _gaps()
    missing = sorted(g for g in gaps if g not in EXCEPTIONS
                     and g.split(":")[0] not in EXCEPTIONS)
    assert not missing, f"no counterpart in the port: {missing}"


def test_every_exception_is_still_needed():
    gaps = _gaps()
    stale = sorted(e for e in EXCEPTIONS if e not in gaps
                   and not any(g.startswith(e + ":") for g in gaps))
    assert not stale, f"listed as exceptions but ported: {stale}"


@pytest.mark.parametrize("rel", ["parallel/__init__.py",
                                 "parallel/distributed.py",
                                 "parallel/data_parallel.py",
                                 "parallel/mesh2d.py"])
def test_parallel_modules_are_ported(rel):
    assert _port_module(rel) is not None
    assert not [g for g in _gaps() if g.startswith(rel)]


def test_surface_is_read():
    surface = _jax_surface()
    assert len(surface) > 200
    assert ("models/idbn.py", "train", ["epochs", "log_every_pca",
                                        "log_every_probe", "fused",
                                        "start_epoch", "checkpoint_every",
                                        "checkpoint_path",
                                        "checkpoint_phase"], "iDBN") \
        in surface
