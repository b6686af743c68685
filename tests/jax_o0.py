"""JAX functions of the port's parity tests, compiled at LLVM level 0.

XLA:CPU spends most of a small test function's compile in LLVM's
optimisation passes (a speech model's VJP: ~10 s at the default level, ~5 s
at level 0). The JAX reference computes the same HLO either way, without
fast-math; the results agree to f32 rounding (a speech LSTM's gradients:
3.8e-6 at most), far inside the tests' tolerances. ``jit(fun)`` compiles
each input signature of ``fun`` with ``xla_backend_optimization_level=0``;
``jit_o0()`` routes ``jax.jit`` itself through it for the duration (the JAX
decoders jit inside their methods). Nothing else of the process changes.
"""

import contextlib

import jax
import numpy as np

OPTIONS = {"xla_backend_optimization_level": 0}
_JIT = jax.jit


def _signature(args):
    leaves, tree = jax.tree_util.tree_flatten(args)
    return tree, tuple((np.shape(x), np.result_type(x)) for x in leaves)


def jit(fun, **jit_kwargs):
    """``jax.jit(fun)`` with each input signature of its positional calls
    compiled at level 0 (with jit options, or called with keywords, the
    plain ``jax.jit``)."""
    jitted = _JIT(fun, **jit_kwargs)
    if jit_kwargs:
        return jitted
    compiled = {}

    def call(*args, **kwargs):
        if kwargs:
            return jitted(*args, **kwargs)
        key = _signature(args)
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=OPTIONS)
        return compiled[key](*args)

    return call


@contextlib.contextmanager
def jit_o0():
    """``jax.jit`` as :func:`jit` inside the block (positional calls of the
    returned function, as the JAX decoders make them)."""
    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = _JIT
