"""mercury-tpu: a software-defined HF modem framework on JAX/XLA.

A from-scratch JAX/XLA reimplementation of the capabilities of the
Rhizomatica/mercury C++ modem: the full
OFDM/MFSK physical layer with IRA-LDPC FEC, adaptive mode ladder, synchronization,
channel estimation, an ARQ data link, and batched multi-channel operation sharded
over device meshes.

Everything on the compute path is pure-functional and statically shaped:
a modem configuration compiles to a `ModeGeometry` of index maps and linear
operators, and the TX/RX chains are jit-compiled batched tensor programs.
"""

__version__ = "0.1.0"
