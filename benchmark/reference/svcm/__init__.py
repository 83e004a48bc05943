"""A frozen copy of the port's plain paths: the benchmark's reference.

Copied from the PyTorch port's modules of the same names (core, scene,
ops, algorithms/vcm.py and pathtracer.py, io/framebuffer.py), cut to one
iteration of one process: the closest-hit and any-hit sweeps are the
dense plain sweeps (ops/sweep.py), the merge is the plain cell merge
(``merge_cells_plain``, ops/merge.py) at the slot counts, and every stage
runs eagerly (graphs.py). The CUDA kernels and graphs, the merge caps, the
pair merge, blocks, process groups, gradients and the image writers are
left out. Nothing here imports the port, so a later change to the port
cannot move the yardstick it is held to.
"""
