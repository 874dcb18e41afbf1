from setuptools import find_packages, setup

setup(
    name="inpaintnet_tpu",
    version="0.1.0",
    packages=find_packages(include=["inpaintnet_tpu", "inpaintnet_tpu.*",
                                    "inpaintnet_tpu_torch", "inpaintnet_tpu_torch.*"]),
    package_data={"inpaintnet_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"]},
)
