"""Graph builders (counterparts of ``amw_tpu.models``)."""

from .analyze import analyze, lufs_analyze_tool
from .chain import compile_chain, default_chain_config
from .pipeline_v1 import build_v1_pipeline, master_v1
from .v2_job import build_v2_job_graph

__all__ = ["analyze", "build_v1_pipeline", "build_v2_job_graph",
           "compile_chain", "default_chain_config", "lufs_analyze_tool",
           "master_v1"]
