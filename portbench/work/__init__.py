"""The work of a frame, counted from its inputs: rays from the path stats
(``rays.count_rays``, the JAX package's convention), operations and bytes
from the scene and the rays (``counts``), and the card's published peaks
(``peaks.json``).  None of it reads how a kernel lays out its inputs, so a
fused or re-laid-out kernel leaves the counts as they are."""
