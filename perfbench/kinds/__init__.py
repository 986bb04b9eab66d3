"""The kinds of cell, one module each, found by name: a mix's ``kind``
names its module here (``"kind": "serve_closed_loop"`` runs
``serve_closed_loop.py``). A module gives ``run``, ``check``,
``attempted`` and ``failed``, and may give ``extra``; ``core.run`` says
what each takes and returns. A later PR adds a kind as a module of its
own."""
