from setuptools import find_packages, setup

setup(
    name="bioscan-clip-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) tri-modal contrastive learning for "
        "BIOSCAN insect images, DNA barcodes, and taxonomic labels"
    ),
    packages=find_packages(include=["bioscan_clip_tpu*"]),
    package_data={
        "bioscan_clip_tpu": ["config/*.yaml", "config/**/*.yaml"],
        "bioscan_clip_tpu_torch": [
            "csrc/*.cu", "csrc/*.cuh", "csrc/host/*.cc", "config/*.yaml",
            "config/**/*.yaml",
        ],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "h5py",
        "pyyaml",
        "pillow",
        "pandas",
        "transformers",
    ],
    extras_require={
        "viz": ["matplotlib", "seaborn", "scikit-learn"],
        "data": ["opencv-python", "scipy"],
        # the PyTorch/CUDA port (bioscan_clip_tpu_torch); its kernels build
        # with nvcc from the CUDA toolkit at first use, its host JPEG decode
        # pool with g++ and libjpeg on data.native_io.build()
        "torch": ["torch", "numpy"],
    },
)
