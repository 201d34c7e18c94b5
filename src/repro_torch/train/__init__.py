"""Training loops of the port (GNN node classification)."""
