"""Ground-truth evaluation harness.

Reference counterpart: the testing-only commands ``check-results``
(``commands/checkResults.d``), ``find-closable-gaps``
(``commands/findClosableGaps.d``) and ``check-scaffolding``.
"""

from .check_results import check_results, GapState, ResultStats
from .closable import find_closable_gaps
