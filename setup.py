"""Package setup (reference has a 97-line setup.py; same role here)."""

from setuptools import find_packages, setup

setup(
    name="sylph_tpu",
    version="0.1.0",
    description=("TPU-native incremental few-shot object detection "
                 "(Sylph hypernetwork framework rebuilt on JAX/XLA)"),
    packages=find_packages(include=["sylph_tpu", "sylph_tpu.*",
                                    "sylph_tpu_torch", "sylph_tpu_torch.*"]),
    package_data={"": ["../configs/**/*.yaml"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "pyyaml",
        "pillow",
    ],
    entry_points={
        "console_scripts": [
            "sylph-train=tools.train_net:main",
        ],
    },
)
