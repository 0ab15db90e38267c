"""Median ms a request of the front end's ``normals`` stage, summed over the
request's calls that time it, by the program's own stage timer (host wall
time, the device synchronised at each mark). A program without the stage
reads nothing."""


def read(layers):
    return layers.stage_median_ms("normals")
