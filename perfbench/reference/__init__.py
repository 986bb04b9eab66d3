"""Plain PyTorch references of the benchmark's configurations, one
module each, found by name: a configuration's file names its module
here (``"reference": "decoder"``), and a configuration of another
architecture brings a module of its own. They import nothing of the
program. A module gives what the kinds of cell ask of it:

- ``draw_weights(shape, seed, device, dtype, std)``: the weights of a
  seed in the program's parameter layout, handed to both sides;
- ``fp32_only()`` and ``fp8(x)``: float32 with TF32 off, and the
  control's rounding of a matrix product's inputs;
- serving: ``Decoder(port, params, quant=None)`` and
  ``served_gaps(model, prompt, served, control=None)``;
- training: ``train_steps(port, params, batches, opt, steps,
  quant=None, rows=None)``.
"""
