"""The port's front ends: the console form (``ui.app``), the tkinter form
(``ui.tkapp``) and the console file dialog (``ui.pathpick``)."""
