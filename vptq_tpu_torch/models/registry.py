"""Known community VPTQ checkpoints (the web app's dropdown).

The port's copy of ``vptq_tpu/models/registry.py``. Informational only:
the port's loader reads local checkpoint directories and downloads
nothing, so selecting one of these hub ids fails in the loader.
"""

COMMUNITY_MODELS = [
    # (hub id, approximate equivalent bitwidth)
    ("VPTQ-community/Meta-Llama-3.1-8B-Instruct-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/Meta-Llama-3.1-8B-Instruct-v8-k65536-0-woft", 2.0),
    ("VPTQ-community/Meta-Llama-3.1-70B-Instruct-v8-k65536-0-woft", 2.0),
    ("VPTQ-community/Meta-Llama-3.1-70B-Instruct-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/Meta-Llama-3.3-70B-Instruct-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/Qwen2.5-7B-Instruct-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/Qwen2.5-14B-Instruct-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/Qwen2.5-32B-Instruct-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/Qwen2.5-72B-Instruct-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/Mistral-Large-Instruct-2407-v8-k65536-256-woft", 3.0),
    ("VPTQ-community/deepseek-r1", 2.5),
]

SUPPORTED_FAMILIES = (
    "llama",
    "mistral",
    "qwen2",
    "phi3",
    "mixtral",
    "deepseek_v2",
    "deepseek_v3",
)
