"""One module a traffic driver, named by a traffic file's ``driver``. Each
holds ``Driver(cell)``, whose construction is the run's set-up (the
program built from the seed's weights, every shape of the mix warmed up),
and whose methods are the run's parts: ``window(seconds)`` -> (end-to-end
metrics, window readings); ``traced()`` -> the traced window's readings;
``flops_per_image()``; ``free_program()``; ``checks(control=False)`` ->
{name: value} against the plain reference, with the reference computed in
fp8 standing in for the program under ``control``. ``attempted`` and
``failed`` count the window's units."""
