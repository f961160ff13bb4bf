"""PyTorch/CUDA port of the DecentLaM reproduction (``repro``).

The package mirrors ``repro``'s subpackages, imports torch and never jax,
and runs on a CUDA device unless the caller asks for the CPU.  The JAX
package stays the reference the port is tested against.
"""
