"""One module a draw that several columns share: ``draws/<name>.py`` with
``make(g)``; ``datagen.TpchColumns.shared(name)`` makes it once a set of
columns."""
