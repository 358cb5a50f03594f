"""A cell kind brought as a file: XL-BOMD as ``xlbomd`` runs it."""
from pbench import cells


class Cell(cells.XLCell):
    pass
