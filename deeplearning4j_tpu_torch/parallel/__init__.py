"""Serving over the port's models: :class:`DecodeEngine`, the
continuous-batching generation loop (port of
``deeplearning4j_tpu/parallel/decode.py``), with its streaming
:class:`GenerationHandle` and :class:`DecodeAIMD` controller. The JAX
package's other ``parallel`` modules (distributed training, batched
inference, pools) are ROADMAP A4 and A8."""

from .decode import DecodeAIMD, DecodeEngine, GenerationHandle

__all__ = ["DecodeAIMD", "DecodeEngine", "GenerationHandle"]
