"""The benchmark's plain reference: plain PyTorch, no kernels, no graphs.

It imports neither JAX, the JAX package nor the port it judges; it builds
its own scene from the configuration's file and works out every image from
the seed and the iteration indices alone.
"""
