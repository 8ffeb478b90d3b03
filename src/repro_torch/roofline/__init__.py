"""The port's roofline: an H100 device model (``hw``) and the terms and
quantized-edge ceilings priced on it (``analysis``)."""
