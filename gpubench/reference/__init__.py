"""Plain PyTorch and numpy references the benchmark judges the port by. They
import nothing of the port and nothing of JAX."""
