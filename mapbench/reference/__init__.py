"""Plain references the benchmark holds the program's outputs to; they
import nothing of the program."""
