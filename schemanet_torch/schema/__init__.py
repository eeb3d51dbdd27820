from .atlas import AtlasConfig, SchemaAtlas, project_atlas_params
from .gnn import GNN, GNNLayer, GraphConv, Matcher, embed_lookup, similarity_fn
from .loss import get_loss_fn, weighted_total
from .predictor import (
    IngredientBackbone,
    SchemaNetConfig,
    SchemaNetPredictor,
    build_predictor,
    init_parameters_,
)
