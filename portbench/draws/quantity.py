"""Line quantities, uniform in 1-50."""

def make(g):
    return g.draw("lineitem", "quantity", 1, 50, g.lines_total())
