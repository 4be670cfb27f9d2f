"""The port's data backends held against the JAX package: its own copy of
the native dot generator (built from its own source into the port's
``_build/``) gives bit-equal images and features for a seed, ``auto``
picks it in both packages, the zipfian loaders give JAX's class indices
and images under both backends, and the port never loads the JAX
package's library. The native library is built once per module."""

import ctypes

import numpy as np
import pytest

import multimodal_idbn_tpu.data as jdata
from multimodal_idbn_tpu.data import native as jnative
from multimodal_idbn_tpu.data import numerosity as jnum

import multimodal_idbn_tpu_torch.data as tdata
from multimodal_idbn_tpu_torch.data import native as tnative
from multimodal_idbn_tpu_torch.data import numerosity as tnum

ARRAYS = ("images", "labels", "class_idx", "onehot", "cumArea", "CH",
          "density", "N_dots")


@pytest.fixture(scope="module")
def built():
    """Both native libraries, built (or found built) once."""
    assert tnative.native_available(), "g++ could not build dotgen.cpp"
    assert jnative.native_available()
    return tnative._lib


def test_source_is_a_byte_copy_and_library_lives_in_build(built):
    assert tnative._SRC.read_bytes() == jnative._SRC.read_bytes()
    path = tnative.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "multimodal_idbn_tpu_torch"
    assert path.exists() and built._name == str(path)
    assert not (tnative._SRC.parent / "_dotgen.so").exists()
    assert built is not jnative._lib
    assert built._name != getattr(jnative._lib, "_name", None)
    assert built.dotgen_version() == 1


def test_native_arrays_bit_equal_to_jax(built):
    """seed 0, n = 64, side 100: the five arrays of the native call and
    every array of the dataset."""
    nums = np.random.RandomState(0).randint(1, 33, 64).astype(np.int32)
    ours = tnative.generate_dot_dataset_native(0, nums, side=100)
    theirs = jnative.generate_dot_dataset_native(0, nums, side=100)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    kw = dict(n_samples=64, num_classes=32, side=100, seed=0)
    ours = tnum.generate_numerosity_dataset(backend="native", **kw)
    theirs = jnum.generate_numerosity_dataset(backend="native", **kw)
    assert sorted(ours) == sorted(theirs) == sorted(ARRAYS)
    for k in ARRAYS:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_auto_picks_native_in_both_packages(built):
    kw = dict(n_samples=24, num_classes=8, side=40, seed=3)
    native = tnum.generate_numerosity_dataset(backend="native", **kw)
    for ours in (tnum.generate_numerosity_dataset(**kw),
                 jnum.generate_numerosity_dataset(**kw)):
        for k in ARRAYS:
            np.testing.assert_array_equal(ours[k], native[k], err_msg=k)
    python = tnum.generate_numerosity_dataset(backend="python", **kw)
    assert not np.array_equal(python["images"], native["images"])
    np.testing.assert_array_equal(python["class_idx"], native["class_idx"])


def test_native_deterministic_and_seed_sensitive(built):
    nums = np.full(8, 5, np.int32)
    a = tnative.generate_dot_dataset_native(7, nums, side=40)[0]
    b = tnative.generate_dot_dataset_native(7, nums, side=40)[0]
    c = tnative.generate_dot_dataset_native(8, nums, side=40)[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])
    imgs, ca, _, _, placed = tnative.generate_dot_dataset_native(
        0, np.arange(1, 17, dtype=np.int32), side=64)
    np.testing.assert_array_equal(placed, np.arange(1, 17))
    np.testing.assert_allclose(imgs.reshape(16, -1).sum(1), ca)


def test_zipf_probs_match():
    for k, a in ((32, 1.0), (5, 2.0), (1, 1.0)):
        np.testing.assert_array_equal(tnum.zipf_probs(k, a),
                                      jnum.zipf_probs(k, a))


@pytest.mark.parametrize("backend", ["native", "python"])
def test_zipfian_loaders_match_jax(built, monkeypatch, backend):
    """The factories of both packages take no backend argument: both
    generators are pinned to the same backend for the comparison."""
    for data, num in ((jdata, jnum), (tdata, tnum)):
        monkeypatch.setattr(
            data, "generate_numerosity_dataset",
            lambda real=num.generate_numerosity_dataset, **kw: real(
                **dict(kw, backend=backend)))
    kw = dict(batch_size=8, n_samples=60, num_classes=6, side=24, seed=1)
    ours = tdata.create_dataloaders_zipfian(**kw)
    theirs = jdata.create_dataloaders_zipfian(**kw)
    for a, b in zip(ours, theirs):
        assert a.dataset.indices == list(b.dataset.indices)
        for x, y in zip(a.materialize(), b.materialize()):
            np.testing.assert_array_equal(x, y)
    base = ours[0].dataset.dataset
    counts = np.bincount(np.argmax(base.onehot, 1), minlength=6)
    assert counts[0] > counts[-1]  # 1/k frequencies


def test_uniform_loaders_default_to_auto(built):
    kw = dict(batch_size=8, n_samples=40, num_classes=4, side=30, seed=0)
    ours = tdata.create_dataloaders_uniform(**kw)
    theirs = jdata.create_dataloaders_uniform(**kw)
    for a, b in zip(ours, theirs):
        for x, y in zip(a.materialize(), b.materialize()):
            np.testing.assert_array_equal(x, y)


def test_native_refuses_and_auto_falls_back_without_a_build(monkeypatch,
                                                            capsys):
    """A failed build: ``native`` raises, as JAX's (numerosity.py:131-132);
    ``auto`` takes the Python generator and says so on stderr."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tnative.BUILD_DIR / "missing-dotgen.so")
    monkeypatch.setattr(tnative, "_compile_library", lambda out: False)
    kw = dict(n_samples=6, num_classes=3, side=20, seed=2)
    with pytest.raises(RuntimeError, match="native dotgen backend "
                                           "unavailable"):
        tnum.generate_numerosity_dataset(backend="native", **kw)
    auto = tnum.generate_numerosity_dataset(**kw)
    python = tnum.generate_numerosity_dataset(backend="python", **kw)
    np.testing.assert_array_equal(auto["images"], python["images"])
    assert "native build failed" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unknown backend"):
        tnum.generate_numerosity_dataset(backend="cuda", **kw)


def test_argtypes_declared(built):
    fn = built.generate_dot_dataset
    assert fn.restype is None and len(fn.argtypes) == 12
    assert built.dotgen_version.restype is ctypes.c_int
