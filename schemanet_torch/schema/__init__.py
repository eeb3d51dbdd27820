from .atlas import AtlasConfig, SchemaAtlas
from .gnn import GNN, GNNLayer, GraphConv, Matcher, similarity_fn
from .predictor import (
    IngredientBackbone,
    SchemaNetConfig,
    SchemaNetPredictor,
    build_predictor,
    init_parameters_,
)
