"""Plain references of the configurations' samplers: plain torch, numpy
and scipy, with nothing of the program under test. A configuration
names its reference module here by ``reference``; the module's
``build(data, args, device, control=False)`` returns the reference (or
its precision control) for one dataset and the sampler's arguments."""
