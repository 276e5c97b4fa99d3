"""Serving for the port: bucketed prefill and chunked decode (``generate``),
continuous batching (``scheduler``) and the prefix KV cache
(``prefix_cache``)."""
