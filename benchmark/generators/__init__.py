"""Traffic generators. A traffic file (``benchmark/traffic/<mix>.json``)
holds parameters and names, under ``generator``, the module here that
reads them; a mix of an existing generator is data alone.

A generator module defines ``Cell(conf, traffic, seed, device)``: one
cell's battle, built from its configuration file (``conf``), its traffic
parameters and the seed, with

- ``setup()``: everything before the window, which ``setup_s`` counts;
  ``split`` holds its parts (seconds, and counts);
- ``window(seconds) -> dict``: the measured window, with the readings the
  metrics' readers take (``frames``, ``wall_s``, ``call_s``,
  ``stepping``, ``order_s``, ``orders_attempted``, ``orders_failed``,
  ``cache_hits``, ``host_scope_ms``, ``cadences``, ``counters``,
  ``nav_stats``, ``events``, ``gc``);
- ``drive(frames) -> int``: the traffic for at least `frames` frames
  (the traced stretch);
- ``record(frames, rec)``: the traffic for `frames` frames more,
  recording each call of the timed path into a ``check.Recorder``: the
  state handed to it, its frames, the state it hands back and
  ``host_columns(n)``;
- ``recorders() -> list``: context managers that ``check.verify`` enters
  beside the ``Recorder`` while ``record`` runs; they only copy, and take
  their patches off on exit;
- ``judge_extra(device) -> dict``: the generator's own numbers, computed
  after the program's state is freed from what its recorders copied, by
  reference code under ``benchmark/reference/`` (which imports neither
  the port nor JAX); each is named in the configuration's limits file;
- ``host_columns(n) -> tuple``: the entity columns the host rewrote
  during the call of `n` frames just made, which the tick comparison
  leaves out of that call (and ``judge_extra`` compares instead);
- ``eng``, ``conf``, ``map_data``, ``device``, ``wave_log`` and
  ``formations`` (a ``check.FormationRecorder`` of set-up's auctions).

``contact.Cell`` is all of that for battles marched into contact and kept
there by reinforcement waves, with no numbers of its own and the nav
cadence's replanned columns as its host columns. A generator with other
traffic subclasses it and extends its hooks: ``prepare()`` (set-up after
the march), ``before_call(n)`` and ``after_call(n)`` (around each call of
the engine's stepping, inside the timed frame), ``goal(arm)`` (where the
player's next order goes), and the three of the check above.
"""
