"""Stages 1 and 3 of the pipeline (port of ``schemanet_tpu/pipeline``): the
codebook extraction, the IR-Atlas initialisation, and the torch-native
bundle and atlas-init files that chain stage 1 to stages 3 and 4."""

from .bundle import Bundle, load_atlas_init, load_bundle, save_atlas_init, save_bundle
from .extract_ingredients import (cluster_features, cluster_saved_features, collect_mid_features,
                                  extract_codebook)
from .init_schema_net import init_atlas
from .stages import extract_stage, init_stage

__all__ = [
    "Bundle",
    "collect_mid_features",
    "extract_codebook",
    "cluster_features",
    "cluster_saved_features",
    "extract_stage",
    "init_atlas",
    "init_stage",
    "load_atlas_init",
    "load_bundle",
    "save_atlas_init",
    "save_bundle",
]
