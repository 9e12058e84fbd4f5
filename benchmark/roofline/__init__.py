"""Work functions of the program's kernels, one file per kernel, and the
table of the card's peaks they are held against. Each counts the problem
a call solves, never the kernel's own layout, so a later redesign of a
kernel is measured against the same least time."""
