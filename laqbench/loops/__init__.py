"""Traffic loops: ``loops/<loop>.py`` drives a cell's plans through the
measured window, as the traffic file's ``loop`` names it."""
