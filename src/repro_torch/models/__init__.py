"""The port's model stack: the dense, MoE, VLM, encoder-decoder, Mamba-1
and hybrid (Mamba-2 + shared attention) families, served on one card
(prefill + greedy decode) and trained."""

from .registry import (ModelApi, frontend_inputs, get_model, input_axes, input_specs,
                       named_param_axes, stacked_param_axes)

__all__ = ["ModelApi", "frontend_inputs", "get_model", "input_axes", "input_specs",
           "named_param_axes", "stacked_param_axes"]
