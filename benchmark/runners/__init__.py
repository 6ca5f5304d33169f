"""One runner per kind of timed path, named by a traffic file's ``runner``."""
