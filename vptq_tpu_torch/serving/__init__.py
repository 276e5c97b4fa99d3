"""Serving for the port: bucketed prefill and chunked decode (``generate``),
continuous batching (``scheduler``), the prefix KV cache
(``prefix_cache``), and the user entry points: the CLI (``cli``, run as
``python -m vptq_tpu_torch``) and the web app (``webapp``)."""
