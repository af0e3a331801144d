from .engine import (BatchScheduler, Request, serve_decode_step,
                     serve_prefill_step)

__all__ = ["BatchScheduler", "Request", "serve_decode_step",
           "serve_prefill_step"]
