"""herdsman_tpu_torch — the PyTorch/CUDA port of herdsman_tpu for NVIDIA Hopper.

The same TFHE gate-bootstrapping stack as ``herdsman_tpu``, module for module,
on ``torch`` tensors: ciphertexts travel as ``torch.int32`` carrying the u32
bit pattern (``ops.u32``), every kernel the JAX package wrote in Pallas is a
hand-written CUDA kernel under ``csrc/`` with a plain PyTorch version beside
it, and every entry point runs on the card (``device="cuda"``) unless the
caller asks for ``device="cpu"``.  The package imports neither ``jax`` nor
``herdsman_tpu``: what it needs of the JAX package's NumPy and pure-Python
modules (parameters, the reference, the circuit model) it keeps as its own
copy.

- ``core``     parameter sets and the exact NumPy reference (client side).
- ``ops``      u32 carrier, polynomial and decomposition primitives, the
               device server key, bootstrapping, gates, programmable (LUT)
               bootstrapping; ``ops.kernels`` holds the CUDA kernels'
               wrappers and their build.
- ``shortint``, ``radix``, ``api``
               the integer tier: short integers over PBS, radix integers
               over shortint blocks, and the eager boolean ``EncUint`` API.
- ``circuit``  the boolean-circuit model and builder, execution plans.
- ``compiler`` levelized circuit evaluation on the device, the optimizer,
               reduce trees and the plan compiler.
- ``service``  the coordinator: auth, sessions, keys, frame storage, the
               job executor and runner (row frames on one device).
- ``utils``    the row codec and the H100 bounds of the kernels' work.
"""

__version__ = "0.1.0"
