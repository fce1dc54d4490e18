"""The plain reference of the benchmark: KmerGMA's hit records worked out
again from a FASTA file and the reference set, in NumPy and plain torch.

It imports nothing of the program (``kmergma_tpu_torch``), of JAX or of
the JAX package.  ``kmergma.find_hits`` is the entry point.
"""
