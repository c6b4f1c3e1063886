"""The benchmark's plain reference: float32 PyTorch, no kernels, no cache.

It computes what the measured program should produce from the same inputs
(the weights ``perfbench.weights`` makes from the seed, the tokens
``perfbench.traffic`` draws), and imports nothing of the program:

* ``layout``: the parameter tree the models take (names, shapes, the
  initial draw of each leaf), the interface both sides share;
* ``model``: the dense decoder (minicpm-2b), layer by layer, with its loss
  and logits;
* ``train``: AdamW with clipping and the WSD or cosine schedule, and a
  step whose backward recomputes one layer at a time, so a full-width
  model's step fits beside its optimizer state;
* ``precision``: the float32 products, and the fp8 ones of the control.
"""
