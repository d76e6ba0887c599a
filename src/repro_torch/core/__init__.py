"""The port's copies of the pure-Python pieces of ``repro.core``: the
paper's network tables (:mod:`.networks`) and the integer helpers of
:mod:`.elastic`.  The TPU tile planner is not copied here."""
