"""One build of the host library (``native/dl4jtpu_native.cpp``) for both
packages' bindings in a test module: the port builds it with ``g++`` into
its git-ignored ``_build/`` and lends it to the JAX binding, whose own first
use would run ``native/build.sh`` (cmake into ``native/build/``) beside the
JAX tests that build it there."""

import ctypes

import pytest

from deeplearning4j_tpu import native as jnative

from deeplearning4j_tpu_torch import native as pnative


@pytest.fixture(scope="module", autouse=True)
def shared_native_library():
    """Yields (JAX binding, port binding) on the port's build, or skips
    the module's native comparisons (yielding None) without a compiler."""
    if not pnative.available():
        yield None
        return
    # the same .so, but its own CDLL object: JAX's argtypes and restypes go
    # on separate function objects, so the port's calls keep the port's own
    # declarations
    jlib = ctypes.CDLL(pnative._lib._name)
    jnative._declare(jlib)
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = jlib, True
    yield jnative, pnative
    jnative._lib, jnative._tried = saved
