"""The plain reference the benchmark holds the program's outputs against.

Plain torch and numpy only: it imports neither JAX nor the JAX package nor
anything of the program (``wgpu_n_body_tpu_torch``), and takes nothing the
program made. From the inputs the benchmark drew it works out again what
the program derived: the Morton order (``order``), the drifted and kicked
state and the forces in float64 (``step``), the octree and the θ-walk's
interactions (``octree``), and the frame (``render``). Each file says the
commit of the program's plain version it was copied from.
"""
