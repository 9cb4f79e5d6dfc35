"""Roofline terms of the port's dry run: the card's constants (``hw``),
the terms and conventions (``analysis``), the counter of a traced step
(``op_count``) and the markdown report (``report``)."""
