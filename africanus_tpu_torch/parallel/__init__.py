from africanus_tpu_torch.parallel.chunked import stream_rows

__all__ = ["stream_rows"]
