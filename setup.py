"""Package setup (reference setup.py parity; pure Python distribution —
the native compute lives in XLA/Pallas kernels compiled at runtime)."""

from setuptools import find_packages, setup

setup(
    name="multimodal-idbn-tpu",
    version="0.1.0",
    description=("TPU-native multimodal iterative Deep Belief Networks "
                 "(JAX/XLA/Pallas rebuild of multimodal-idbn)"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["multimodal_idbn_tpu",
                                    "multimodal_idbn_tpu.*",
                                    "multimodal_idbn_tpu_torch",
                                    "multimodal_idbn_tpu_torch.*"]),
    # the port's CUDA sources are built at run time (ops/_cuda.py); its
    # quality pools and the probe's initial weights are data (quality.py)
    package_data={"multimodal_idbn_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                                "records/*.json",
                                                "records/*.npz"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy",
        "pyyaml",
    ],
    extras_require={
        "diagnostics": ["matplotlib", "scipy", "pandas"],
        "wandb": ["wandb"],
        "dev": ["pytest"],
        # the PyTorch/CUDA port (multimodal_idbn_tpu_torch)
        "torch": ["torch"],
    },
    license="MIT",
)
