"""Plain float32 references of the benchmark's configurations.  They
import nothing of the program: they read the benchmark's weights and
tokens and compute the model's stated mathematics with plain torch."""
