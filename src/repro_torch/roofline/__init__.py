"""The roofline over the dry run's records, on one H100's constants (port
of ``roofline/``): ``hlo`` counts collective bytes, ``analysis`` turns a
record into compute, memory and collective terms, ``report`` and
``compare`` print them, and ``kernel_costs`` holds the hand-written
kernels' operations and bytes."""
