"""Training of the port: the GNN node classifier (``gnn``) and the LM
step and loop (``optimizer``, ``grad_compress``, ``loop``, ``pipeline``)."""
