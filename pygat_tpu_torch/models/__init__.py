"""GAT configuration, parameters, layers and model."""
