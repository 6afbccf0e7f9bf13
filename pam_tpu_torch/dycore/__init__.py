from .awfl import AwflDycore
