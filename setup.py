"""Packaging — the reference ships setup.py with AOT op builds (setup.py:89);
here there is nothing to precompile for the JAX path, and the native C++
host libraries (deepspeed_tpu/csrc) build lazily via the op builder at
first use (deepspeed_tpu/ops/native)."""

from setuptools import setup, find_packages

setup(
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native large-model training framework "
                "(DeepSpeed-capability rebuild on JAX/XLA/Pallas)",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch",
                                    "deepspeed_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these at first use
    package_data={"deepspeed_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "numpy"],
    entry_points={
        "console_scripts": [
            "dstpu=deepspeed_tpu.launcher.runner:main",
            "dstpu_launch=deepspeed_tpu.launcher.launch:main",
            "dstpu_report=deepspeed_tpu.env_report:main",
            "dstpu_elastic=deepspeed_tpu.elasticity.cli:main",
        ],
    },
)
