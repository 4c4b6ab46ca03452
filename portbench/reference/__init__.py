"""Plain references the benchmark judges the program against: FASTA in
plain PyTorch over a leading axis of independent instances, and each
configuration kind's operator, terms and objective.  They import nothing
of the program, of the JAX package or of ``reference_oracle``, and work
out everything from the inputs the benchmark makes."""
