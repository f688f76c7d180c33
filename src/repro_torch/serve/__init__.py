"""Serving substrate of the port: prefill/decode steps (``step``) and the
continuous-batching engine (``engine``)."""
