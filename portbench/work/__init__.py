"""The work of a step or a served batch, counted from the configuration's
shapes: the model FLOPs of the convolutions and dense layers (``flops``)
and the bytes and FLOPs of each pass of the five hand-written ops
(``ops``)."""
