"""Generation for the port: bucketed prefill and chunked decode."""
