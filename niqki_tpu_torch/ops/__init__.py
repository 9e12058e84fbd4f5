"""Device ops of the port: the sketch (plain torch around kernel K1,
``psort``) and the bit-plane count (kernel K2, ``bcount``)."""
