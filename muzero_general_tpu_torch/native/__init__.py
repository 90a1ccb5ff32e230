"""Native code: the nvcc build and ctypes loading of csrc/*.cu, and the g++
build of the replay batch assembler (replay_sampler.cpp), in build.py."""
