"""Native code: the nvcc build and ctypes loading of csrc/*.cu (build.py)."""
