"""Package setup for safeopt-tpu."""

from setuptools import find_packages, setup

setup(
    name="safeopt-tpu",
    version="0.1.0",
    description=("Accelerator-native safe Bayesian optimization: SafeOpt / "
                 "SafeOptSwarm with an in-repo JAX GP engine"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=("tests", "examples", "benchmarks")),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    extras_require={
        "plotting": ["matplotlib"],
        "sampling-linear": ["scipy"],
        "dev": ["pytest", "scipy", "matplotlib"],
    },
    license="MIT",
    classifiers=[
        "Development Status :: 4 - Beta",
        "Intended Audience :: Science/Research",
        "License :: OSI Approved :: MIT License",
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
    ],
)
