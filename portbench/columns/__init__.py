"""One module a generated column: ``columns/<table>/<column>.py`` with
``TYPE`` (its SQL type), ``CATEGORIES`` (the values of a string column, coded
1.., else None) and ``make(g)``, which returns the column on ``g.device``
from a ``datagen.TpchColumns`` ``g``.  ``datagen`` finds each by name."""
