"""Command-line interface of the port (the JAX package's `cli/`):
config-driven train, eval and predict entry points whose flag names,
defaults and printed lines are the JAX CLIs'. One CLI for the whole zoo;
each runs on the CUDA card unless `--device cpu` asks for the CPU.
"""
