"""The plain reference: dense PyTorch in float32 with TF32 off, written from
the models' equations.  It imports nothing of the program and takes
nothing the program made: it normalises the adjacency again from the raw
0/1 matrix the benchmark drew, and starts from the weights the benchmark
made."""
