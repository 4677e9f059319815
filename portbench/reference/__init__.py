"""The plain reference: one module per query shape, found by the shape's
name (``q1.py`` answers ``queries/q1.json``).  Each module gives
``answer(t, params, control=False)``, the rows as ``{column: [values]}``
over ``_common.Tables`` ``t``, and ``ORDER_BY``/``LIMIT``, which tell
``check.py`` how the rows may be ordered.  An ORDER BY ... LIMIT answer
holds every row that ties with the last one kept, so that any correct
choice among them passes.  ``control=True`` is the control of
``control.py``: the shape's decimal arithmetic in float64 where the
shape has a lower-precision form (Q1, Q6); other shapes ignore it.
Plain torch and numpy only; nothing of the system under test.
"""
