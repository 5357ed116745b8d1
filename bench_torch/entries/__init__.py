"""The units of work, one file an entry (``entries/<entry>.py``), found
by the ``entry`` a traffic mix names. Each file gives

- ``build(cfg, device, seed, control)``: the configuration's state on
  the card;
- ``REFERENCE``: the name of its plain reference (``reference/<name>.py``);
- ``Entry(state, cfg, mix, items, seed, spans)``: the mix's inputs made
  from the seed, called with a pool index for one analysis, and its
  comparison with the reference once the window has closed.

A new unit of work is a new file here, and a new reference a new file
there: no file already present is edited.
"""
